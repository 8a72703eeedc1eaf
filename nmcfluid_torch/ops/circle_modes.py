"""Exterior screened-harmonic (Bessel-K modal) circle correction (port of
nmcfluid/ops/circle_modes.py), for karman under the spectral projection.

The box solve p0 leaves a normal-derivative residual dp0/dr on the
obstacle circle. The homogeneous screened equation separates around the
circle's centre into exterior-decaying modes

    q(r, theta) = sum_m rho_m(r) (A_m cos m theta + B_m sin m theta),
    rho_m(r)    = K_m(sqrt(sigma) r) / K_m(sqrt(sigma) a),

so cancelling the residual is one diagonal solve per mode.

K_m overflows float32 past m ~ 30, so the device works with ratios only:
rho_m by the upward recurrence (K_m dominates in m, so it is stable),
tau_m = K_{m-1}/K_m by its continued-fraction recurrence, and the
constants at the circle from float64 scipy.special.kve on the host,
passed as Python floats.
"""
import math

import numpy as np
import scipy.special as _sps
import torch

from ..geometry.sdf import sqrt_rn
from .bessel import k0e, k1e


def _host_consts(z0: float, n_modes: int):
    """Float64 constants at the circle argument z0: d1[i] =
    K_{i-1}(z0)/K_{i+1}(z0) and d2[i] = K_i(z0)/K_{i+1}(z0) (the
    recurrence's couplings; the i = 0 entries are unused), and s[m] =
    K'_m(z0)/K_m(z0) (< 0)."""
    m = np.arange(0, n_modes + 1)
    kv = _sps.kve(m, z0)                  # K_m(z0) e^{z0}
    d1 = np.ones(n_modes)
    d2 = np.ones(n_modes)
    d1[1:] = kv[0:n_modes - 1] / kv[2:n_modes + 1]
    d2[1:] = kv[1:n_modes] / kv[2:n_modes + 1]
    # K'_m = -(K_{m-1} + K_{m+1})/2, with K_{-1} = K_1
    km1 = np.concatenate([[kv[1]], kv[:n_modes - 1]])
    s = -(km1 + kv[1:n_modes + 1]) / (2.0 * kv[:n_modes])
    s[0] = -kv[1] / kv[0]
    return d1, d2, s


def _mode_tables(pts, center, radius, sigma, n_modes):
    """(r, theta, rhos (N, M), lams (N, M)) at pts (N, 2): rho_m(r) and
    lam_m(z) = K'_m(z)/K_m(z)."""
    rs = math.sqrt(sigma)
    z0 = rs * radius
    d1, d2, _ = _host_consts(z0, n_modes)
    k0z0 = float(_sps.k0e(z0))
    k1z0 = float(_sps.k1e(z0))

    dx = pts[..., 0] - float(center[0])
    dy = pts[..., 1] - float(center[1])
    r = torch.clamp(sqrt_rn(dx * dx + dy * dy), min=radius)
    theta = torch.atan2(dy, dx)
    z = rs * r
    expd = torch.exp(z0 - z)
    k0z, k1z = k0e(z), k1e(z)
    rho = [k0z / k0z0 * expd, k1z / k1z0 * expd]
    tau = [None, k0z / k1z]               # tau_m = K_{m-1}/K_m at z
    for i in range(1, n_modes):
        rho.append(float(d1[i]) * rho[i - 1]
                   + (2.0 * i / z) * float(d2[i]) * rho[i])
        tau.append(1.0 / (tau[i] + 2.0 * i / z))
    lams = [-1.0 / tau[1]] + [-(tau[m] + m / z) for m in range(1, n_modes)]
    return r, theta, torch.stack(rho[:n_modes], -1), torch.stack(lams, -1)


def fit_circle_correction(g_grid, scene_size, center, radius, sigma,
                          n_modes=32, n_bdry=512):
    """The modal coefficients (A, B) that cancel the obstacle's Neumann
    residual of a box solve; g_grid (res_x, res_y, 2) is the gradient of
    the box solution on the cell-centered grid."""
    from ..sim.sampling import bilinear_lookup
    dev = g_grid.device
    z0 = math.sqrt(sigma) * radius
    _, _, s = _host_consts(z0, n_modes)
    theta = (2.0 * math.pi / n_bdry) * torch.arange(
        n_bdry, dtype=torch.float32, device=dev)
    ct, st = torch.cos(theta), torch.sin(theta)
    pts = torch.stack([center[0] + radius * ct, center[1] + radius * st], -1)
    gx = bilinear_lookup(g_grid[..., 0], scene_size, pts)
    gy = bilinear_lookup(g_grid[..., 1], scene_size, pts)
    h = -(gx * ct + gy * st)          # want dr(p0 + q) = 0 at r = a
    m = torch.arange(n_modes, dtype=torch.float32, device=dev)
    cos_mt = torch.cos(m[:, None] * theta[None, :])     # (M, B)
    sin_mt = torch.sin(m[:, None] * theta[None, :])
    scale = torch.where(m == 0, 1.0 / n_bdry, 2.0 / n_bdry)
    h_cos = scale * (cos_mt @ h)
    h_sin = scale * (sin_mt @ h)
    # dr q(a, theta) = sum_m sqrt(sigma) s_m (A_m cos + B_m sin) = h
    denom = math.sqrt(sigma) * torch.tensor(s, dtype=torch.float32,
                                            device=dev)
    return h_cos / denom, h_sin / denom


def eval_circle_correction(coeffs, pts, center, radius, sigma, n_modes=32):
    """(q, grad q) at pts (N, 2). Points inside the circle evaluate at the
    clamped radius; the boundary masking zeroes them downstream."""
    A, B = coeffs
    r, theta, rhos, lams = _mode_tables(pts, center, radius, sigma,
                                        n_modes)
    rs = math.sqrt(sigma)
    mvals = torch.arange(n_modes, dtype=pts.dtype, device=pts.device)
    cos_mt = torch.cos(theta[:, None] * mvals[None, :])   # (N, M)
    sin_mt = torch.sin(theta[:, None] * mvals[None, :])
    ang = A[None, :] * cos_mt + B[None, :] * sin_mt
    dang = mvals[None, :] * (-A[None, :] * sin_mt + B[None, :] * cos_mt)
    q = torch.sum(rhos * ang, -1)
    dq_dr = rs * torch.sum(rhos * lams * ang, -1)
    dq_dt = torch.sum(rhos * dang, -1)
    ct, st = torch.cos(theta), torch.sin(theta)
    gx = dq_dr * ct - dq_dt * st / r
    gy = dq_dr * st + dq_dt * ct / r
    return q, torch.stack([gx, gy], -1)
