"""Physics-informed DeepONet baseline in PyTorch (port of
nmcfluid/baselines/pideeponet.py).

Rebuild of experiments/piDeepONetSolver/{model.py,networks.py}: a
branch net encodes the initial velocity sampled at 100 fixed sensor points
(200-dim input) and a trunk net encodes (x, y, t); each produces
n_out-per-channel basis coefficients combined by an inner product into
(u, v, p). Trained with the same composite PINN loss (init / bound /
NS residual / div, model.py:171-215); the (N, 3, 3) Jacobian is the
trunk's tangents (apply_siren_tangents) contracted with the branch's
coefficients.
"""
import numpy as np
import torch

from .. import get_device
from ..models.siren import apply_siren_tangents
from ..utils.keys import Key
from .common import (SirenConfig, adam_fit, apply_siren, init_siren,
                     sample_interior, tg_velocity)
from .pinn import boundary_points, with_time


class PIDeepONetFluid:
    def __init__(self, num_hidden_layers=3, hidden_features=256, lr=1e-4,
                 max_n_iters=50_000, sample_resolution=128, t_range=2.5,
                 n_sensors=100, n_out=60, n_fields=3, device=None):
        # defaults = piDeepONetSolver/config.py:93-94,105,108,146 +
        # model.py:36-44: n_out=60 coefficients TOTAL, split 20 per
        # field (networks.py:19-20), combined by an UNnormalized inner
        # product plus a learned per-field bias (networks.py:16,28)
        self.n_fields = n_fields
        self.n_basis = n_out // n_fields
        self.branch_cfg = SirenConfig(n_sensors * 2, n_out,
                                      num_hidden_layers, hidden_features)
        self.trunk_cfg = SirenConfig(3, n_out,
                                     num_hidden_layers, hidden_features)
        self.lr = lr
        self.max_n_iters = max_n_iters
        self.n = sample_resolution ** 2
        self.t_range = t_range
        self.device = get_device(device)
        # fixed sensor grid (model.py:47-48)
        side = int(np.sqrt(n_sensors))
        ax = (np.arange(side) + 0.5) / side * 2.0 - 1.0
        gx, gy = np.meshgrid(ax, ax, indexing="ij")
        self.sensors = torch.tensor(np.stack([gx, gy], -1).reshape(-1, 2),
                                    dtype=torch.float32, device=self.device)
        self.v0 = tg_velocity(self.sensors).reshape(-1)   # (200,)

    def init(self, seed=0, key=None):
        """Random weights from `seed`, or from a key object `key`."""
        key = Key(seed) if key is None else key
        k1, k2 = key.split(2)
        return dict(branch=init_siren(k1, self.branch_cfg, self.device),
                    trunk=init_siren(k2, self.trunk_cfg, self.device),
                    b=torch.zeros(self.n_fields, device=self.device))

    def _coefficients(self, state):
        b = apply_siren(state["branch"], self.branch_cfg, self.v0)
        return b.reshape(self.n_fields, self.n_basis)

    def field(self, state, xt):
        """(..., 3) -> (..., n_fields): sum_k B_k T_k + b
        (networks.py:23-29; no normalization)."""
        b = self._coefficients(state)
        t = apply_siren(state["trunk"], self.trunk_cfg, xt)
        t = t.reshape(xt.shape[:-1] + (self.n_fields, self.n_basis))
        return torch.sum(b * t, dim=-1) + state["b"]

    def field_tangents(self, state, xt):
        """The field at xt (M, 3) and its derivative along every input
        axis: ((M, n_fields), (3, M, n_fields))."""
        b = self._coefficients(state)
        t, dt = apply_siren_tangents(state["trunk"], self.trunk_cfg, xt)
        shape = (xt.shape[0], self.n_fields, self.n_basis)
        out = torch.sum(b * t.reshape(shape), dim=-1) + state["b"]
        return out, torch.sum(b * dt.reshape((3,) + shape), dim=-1)

    def velocity(self, state, x, t):
        return self.field(state, with_time(x, t))[..., :2]

    def loss(self, st, ki):
        k0, k1, k2, k3 = ki.split(4)
        dev = self.device
        x0 = sample_interior(k0, self.n, dev)
        li = torch.mean((self.velocity(st, x0, 0.0) - tg_velocity(x0)) ** 2)
        xb, nb = boundary_points((k1, k2), self.n // 100, self.t_range, dev)
        fb = self.field(st, xb)
        lb = torch.mean(fb[:nb, 0] ** 2) + torch.mean(fb[nb:, 1] ** 2)
        x = sample_interior(k3, self.n, dev)
        tt = k3.fold_in(1).uniform((self.n, 1), dev) * self.t_range
        out, dout = self.field_tangents(st, with_time(x, tt))
        u = out[:, :2]
        div = dout[0, :, 0] + dout[1, :, 1]
        adv = u[:, :1] * dout[0, :, :2] + u[:, 1:] * dout[1, :, :2]
        gp = dout[:2, :, 2].T
        resid = dout[2, :, :2] + adv + gp
        lm = torch.mean(resid ** 2)
        ld = torch.mean(div ** 2)
        return li + lb + lm + ld

    def train(self, state, key):
        # ExponentialLR parity: both reference trainers decay lr x0.95^1e-4
        # per step (model.py:68); their plateau lines are commented out
        return adam_fit(state, key, self.loss, self.lr, self.max_n_iters,
                        exp_gamma=0.95 ** 1e-4)
