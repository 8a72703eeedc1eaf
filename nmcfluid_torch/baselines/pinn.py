"""Space-time PINN baseline in PyTorch (port of nmcfluid/baselines/pinn.py).

Rebuild of experiments/pinnFluid/model.py:163-205: one velocity network
u(x, y, t) and one pressure network p(x, y, t) trained jointly over the
whole time range with a composite loss
  init  : u(x, 0) = TG
  bound : zero normal wall velocity at random times
  main  : du/dt + (u . grad) u + grad p = 0   (inviscid NS residual)
  div   : div u = 0
then evaluated per-frame for the error curve. The Jacobians come from
apply_siren_tangents (forward mode written out, differentiable by the
weights).
"""
import torch

from .. import get_device
from ..models.siren import apply_siren_tangents
from ..utils.keys import Key
from .common import (SirenConfig, adam_fit, apply_siren, init_siren,
                     sample_boundary, sample_interior, tg_velocity)


def with_time(x, t):
    """(..., 2) points and a time (a number or an (..., 1) tensor) ->
    (..., 3)."""
    if not isinstance(t, torch.Tensor):
        t = torch.full(x.shape[:-1] + (1,), t, dtype=torch.float32,
                       device=x.device)
    return torch.cat([x, t], -1)


def boundary_points(key, n, t_range, device):
    """The boundary term's space-time samples (sample_boundary at n each
    and their times): (points (2n, 3), n)."""
    k1, k2 = key
    xv, xh = sample_boundary(k1, n, device)
    tb = k2.uniform((n, 1), device) * t_range
    return torch.cat([with_time(xv, tb), with_time(xh, tb)]), n


class PINNFluid:
    def __init__(self, num_hidden_layers=3, hidden_features=256, lr=1e-4,
                 max_n_iters=50_000, sample_resolution=128, t_range=2.5,
                 device=None):
        # defaults = pinnFluid/config.py:90-91,102,105,143 (3x256, 50k
        # iters, lr 1e-4, t_range 2.5 — trained over [0, 2.5] though the
        # error curve only evaluates t in [0, 0.05], save_vel.py:23-47)
        self.u_cfg = SirenConfig(3, 2, num_hidden_layers, hidden_features)
        self.p_cfg = SirenConfig(3, 1, num_hidden_layers, hidden_features)
        self.lr = lr
        self.max_n_iters = max_n_iters
        self.n = sample_resolution ** 2
        self.t_range = t_range
        self.device = get_device(device)

    def init(self, seed=0, key=None):
        """Random weights from `seed`, or from a key object `key`."""
        key = Key(seed) if key is None else key
        k1, k2 = key.split(2)
        return dict(u=init_siren(k1, self.u_cfg, self.device),
                    p=init_siren(k2, self.p_cfg, self.device))

    def velocity(self, state, x, t):
        return apply_siren(state["u"], self.u_cfg, with_time(x, t))

    def loss(self, st, ki):
        k0, k1, k2, k3 = ki.split(4)
        dev = self.device
        # init
        x0 = sample_interior(k0, self.n, dev)
        li = torch.mean((self.velocity(st, x0, 0.0) - tg_velocity(x0)) ** 2)
        # boundary
        xb, nb = boundary_points((k1, k2), self.n // 100, self.t_range, dev)
        ub = apply_siren(st["u"], self.u_cfg, xb)
        lb = torch.mean(ub[:nb, 0] ** 2) + torch.mean(ub[nb:, 1] ** 2)
        # residuals
        x = sample_interior(k3, self.n, dev)
        tt = k3.fold_in(1).uniform((self.n, 1), dev) * self.t_range
        xt = with_time(x, tt)
        u, du = apply_siren_tangents(st["u"], self.u_cfg, xt)  # du[i]: d/dx_i
        div = du[0, :, 0] + du[1, :, 1]
        adv = u[:, :1] * du[0] + u[:, 1:] * du[1]
        gp = apply_siren_tangents(st["p"], self.p_cfg, xt)[1][:2, :, 0].T
        resid = du[2] + adv + gp
        lm = torch.mean(resid ** 2)
        ld = torch.mean(div ** 2)
        return li + lb + lm + ld

    def train(self, state, key):
        # ExponentialLR parity: both reference trainers decay lr x0.95^1e-4
        # per step (model.py:68); their plateau lines are commented out
        return adam_fit(state, key, self.loss, self.lr, self.max_n_iters,
                        exp_gamma=0.95 ** 1e-4)
