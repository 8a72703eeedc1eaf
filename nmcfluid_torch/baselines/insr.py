"""INSR-PDE fluid baseline (Wu et al.) in PyTorch (port of
nmcfluid/baselines/insr.py).

Rebuild of experiments/INSR-PDE/fluid/model.py: three networks — velocity,
velocity_prev, and a *pressure network* — stepped by
  advect   : semi-Lagrangian fit + soft wall penalty        (:74-101)
  pressure : PINN fit of lap p = div u + Neumann penalty    (:104-125)
  project  : fit u_prev - grad p + soft wall penalty        (:127-151)
Soft boundary losses on 1%-of-batch wall samples replace the main method's
hard BCs. The derivatives in the losses come from forward mode written out
on plain tensor ops (models/siren.py: apply_siren_tangents for div u and
grad p, apply_siren_second for lap p), so autograd differentiates them by
the weights.
"""
import torch

from .. import get_device
from ..models.siren import apply_siren_second, apply_siren_tangents
from ..utils.keys import Key
from .common import (SegmentedAdam, SirenConfig, apply_siren, init_siren,
                     sample_boundary, sample_interior, tg_velocity)


class INSRFluid:
    def __init__(self, num_hidden_layers=3, hidden_features=256, lr=1e-4,
                 max_n_iters=20_000, sample_resolution=128, dt=0.001,
                 bc_weight=1.0, device=None):
        # defaults = the reference experiment's shipped config
        # (scripts/fluid2Dtlgn.sh: 3 layers x 256, -sr 128, dt 1e-3;
        # config.py:107-108: max_n_iters 20000, lr 1e-4)
        self.vel_cfg = SirenConfig(2, 2, num_hidden_layers, hidden_features)
        self.p_cfg = SirenConfig(2, 1, num_hidden_layers, hidden_features)
        self.max_n_iters = max_n_iters
        self.n = sample_resolution ** 2
        self.dt = dt
        self.bc_weight = bc_weight
        self.device = get_device(device)
        # one fitter per phase; plateau=True = the reference's
        # ReduceLROnPlateau per phase (base/baseModel.py:61, factor 0.1 /
        # patience 500 / min_lr 1e-8). Each keeps its last fit's
        # iterations and seconds.
        self._fits = {
            "source": SegmentedAdam(self._source_loss, lr, plateau=True),
            "advect": SegmentedAdam(self._advect_loss, lr, plateau=True),
            "pressure": SegmentedAdam(self._pressure_loss, lr,
                                      plateau=True),
            "project": SegmentedAdam(self._project_loss, lr, plateau=True),
        }

    def init(self, seed=0, key=None):
        """Random weights from `seed`, or from a key object `key`."""
        key = Key(seed) if key is None else key
        k1, k2 = key.split(2)
        return dict(vel=init_siren(k1, self.vel_cfg, self.device),
                    p=init_siren(k2, self.p_cfg, self.device))

    def _vel(self, params, x):
        return apply_siren(params, self.vel_cfg, x)

    def _walls(self, kb):
        """The wall samples, vertical walls' first: (points, n each)."""
        xv, xh = sample_boundary(kb, self.n // 100, self.device)
        return torch.cat([xv, xh]), xv.shape[0]

    def _bc_loss(self, params, kb):
        xw, nv = self._walls(kb)
        u = self._vel(params, xw)
        vx, vy = u[:nv, 0], u[nv:, 1]
        return (torch.mean(vx ** 2) + torch.mean(vy ** 2)) * self.bc_weight

    # ---- per-phase losses (loss(params, key_i, *ctx); ctx carries the
    # frozen nets of the phase)

    def _source_loss(self, p, ki):
        x = sample_interior(ki, self.n, self.device)
        main = torch.mean((self._vel(p, x) - tg_velocity(x)) ** 2)
        return main + self._bc_loss(p, ki.fold_in(1))

    def _advect_loss(self, p, ki, prev):
        x = sample_interior(ki, self.n, self.device)
        u_prev = self._vel(prev, x)
        back = torch.clamp(x - u_prev * self.dt, -1.0, 1.0)
        target = self._vel(prev, back)
        main = torch.mean((self._vel(p, x) - target) ** 2)
        return main + self._bc_loss(p, ki.fold_in(1))

    def _pressure_loss(self, pp, ki, vel_params):
        """lap p = div u with Neumann walls (model.py:104-125)."""
        x = sample_interior(ki, self.n, self.device)
        _, du = apply_siren_tangents(vel_params, self.vel_cfg, x)
        div_u = du[0, :, 0] + du[1, :, 1]
        _, _, d2p = apply_siren_second(pp, self.p_cfg, x)
        lap_p = d2p[0, :, 0] + d2p[1, :, 0]
        main = torch.mean((div_u - lap_p) ** 2)
        xw, nv = self._walls(ki.fold_in(1))
        _, dp = apply_siren_tangents(pp, self.p_cfg, xw)
        gpx, gpy = dp[0, :nv, 0], dp[1, nv:, 0]
        return main + torch.mean(gpx ** 2) + torch.mean(gpy ** 2)

    def _project_loss(self, p, ki, prev, p_params):
        x = sample_interior(ki, self.n, self.device)
        u_prev = self._vel(prev, x)
        _, dp = apply_siren_tangents(p_params, self.p_cfg, x)
        grad_p = dp[..., 0].T
        main = torch.mean((self._vel(p, x) - (u_prev - grad_p)) ** 2)
        return main + self._bc_loss(p, ki.fold_in(1))

    # ---- the phases

    def phase_stats(self):
        """{phase: (iterations, seconds)} of each phase's last fit."""
        return {k: (f.iters, f.seconds) for k, f in self._fits.items()}

    def fit_source(self, params, key):
        return self._fits["source"].fit(params, key, self.max_n_iters)

    def advect(self, params, prev, key):
        return self._fits["advect"].fit(params, key, self.max_n_iters,
                                        ctx=(prev,))[0]

    def solve_pressure(self, p_params, vel_params, key):
        return self._fits["pressure"].fit(p_params, key, self.max_n_iters,
                                          ctx=(vel_params,))[0]

    def project(self, params, prev, p_params, key):
        return self._fits["project"].fit(params, key, self.max_n_iters,
                                         ctx=(prev, p_params))[0]

    def step(self, state, key):
        """One INSR timestep: advect -> pressure -> project."""
        k1, k2, k3 = key.split(3)
        prev = state["vel"]
        vel = self.advect(state["vel"], prev, k1)
        p = self.solve_pressure(state["p"], vel, k2)
        vel2 = self.project(vel, vel, p, k3)
        return dict(vel=vel2, p=p)
