"""Exterior screened-harmonic correction for karman3d's cylinder (port of
nmcfluid/ops/cylinder_modes.py).

The box solve p0 leaves a radial Neumann residual h(theta, y) on the
cylinder rho = a along y (rho the in-plane distance in (x, z)). The
homogeneous screened equation separates in cylindrical coordinates with a
y-cosine basis that keeps the cube's y-walls Neumann:

    q = sum_{j,m} rho^{(j)}_m(rho) [A_jm cos m theta + B_jm sin m theta]
        * cos(k_j (y - y_lo)),    k_j = j pi / Ly,

one circle problem (circle_modes) per j at the screening sigma + k_j^2,
solved diagonally through a theta-DFT and a y-DCT of the residual.
"""
import math

import numpy as np
import torch

from .circle_modes import _host_consts, _mode_tables


def fit_cylinder_correction(g_grid, scene_size, center_xz, radius, sigma,
                            n_modes=24, n_y=12, n_theta=64, n_ys=48):
    """(A, B), each (n_y, n_modes), cancelling the cylinder's Neumann
    residual; g_grid (res, res, res, 3) is the box solution's gradient on
    the cell-centered grid (axes x, y, z)."""
    from ..sim.sampling import bilinear_lookup
    dev = g_grid.device
    f32 = dict(dtype=torch.float32, device=dev)
    x0, x1, y0, y1, z0_, z1_ = scene_size
    Ly = y1 - y0
    cx, cz = center_xz
    theta = (2.0 * math.pi / n_theta) * torch.arange(n_theta, **f32)
    # y samples at the cell centres of a DCT-II grid: exact cosine
    # quadrature
    ys = y0 + (torch.arange(n_ys, **f32) + 0.5) * (Ly / n_ys)
    ct, st = torch.cos(theta), torch.sin(theta)
    px = (cx + radius * ct)[None, :].expand(n_ys, n_theta)
    pz = (cz + radius * st)[None, :].expand(n_ys, n_theta)
    pts = torch.stack([px, ys[:, None].expand(n_ys, n_theta), pz], -1)
    flat = pts.reshape(-1, 3)
    gx = bilinear_lookup(g_grid[..., 0], scene_size, flat)
    gz = bilinear_lookup(g_grid[..., 2], scene_size, flat)
    h = -(gx.reshape(n_ys, n_theta) * ct[None]
          + gz.reshape(n_ys, n_theta) * st[None])   # want d_rho(p0+q)=0

    # theta-DFT
    m = torch.arange(n_modes, **f32)
    cos_mt = torch.cos(m[:, None] * theta[None, :])      # (M, T)
    sin_mt = torch.sin(m[:, None] * theta[None, :])
    scale_t = torch.where(m == 0, 1.0 / n_theta, 2.0 / n_theta)
    h_cos = (h @ cos_mt.T) * scale_t[None, :]            # (Ys, M)
    h_sin = (h @ sin_mt.T) * scale_t[None, :]
    # y-DCT (Neumann-compatible cosines)
    j = torch.arange(n_y, **f32)
    cos_jy = torch.cos(j[:, None] * math.pi / Ly * (ys[None, :] - y0))
    scale_y = torch.where(j == 0, 1.0 / n_ys, 2.0 / n_ys)
    Hc = scale_y[:, None] * (cos_jy @ h_cos)             # (J, M)
    Hs = scale_y[:, None] * (cos_jy @ h_sin)

    # per-j diagonal solve: d_rho q|_a = s_j * s_m(z0_j) * coeff = H
    denoms = []
    for jj in range(n_y):
        s_j = math.sqrt(sigma + (jj * math.pi / Ly) ** 2)
        _, _, s = _host_consts(s_j * radius, n_modes)
        denoms.append(s_j * np.asarray(s))
    denom = torch.tensor(np.stack(denoms), **f32)
    return Hc / denom, Hs / denom


def eval_cylinder_correction(coeffs, pts, scene_size, center_xz, radius,
                             sigma, n_modes=24, n_y=12):
    """(q, grad q) at pts (N, 3). Points inside the cylinder evaluate at
    the clamped radius; the boundary masking zeroes them downstream."""
    A, B = coeffs
    y0, y1 = scene_size[2], scene_size[3]
    Ly = y1 - y0
    pts_xz = torch.stack([pts[:, 0], pts[:, 2]], -1)
    y = pts[:, 1]
    q = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    gx = torch.zeros_like(q)
    gy = torch.zeros_like(q)
    gz = torch.zeros_like(q)
    mvals = torch.arange(n_modes, dtype=pts.dtype, device=pts.device)
    for jj in range(n_y):
        k_j = jj * math.pi / Ly
        sig_eff = sigma + k_j ** 2
        r, theta, rhos, lams = _mode_tables(pts_xz, center_xz, radius,
                                            sig_eff, n_modes)
        rs = math.sqrt(sig_eff)
        cos_mt = torch.cos(theta[:, None] * mvals[None, :])
        sin_mt = torch.sin(theta[:, None] * mvals[None, :])
        ang = A[jj][None, :] * cos_mt + B[jj][None, :] * sin_mt
        dang = mvals[None, :] * (-A[jj][None, :] * sin_mt
                                 + B[jj][None, :] * cos_mt)
        cy = torch.cos(k_j * (y - y0))
        sy = torch.sin(k_j * (y - y0))
        q2 = torch.sum(rhos * ang, -1)
        dq_dr = rs * torch.sum(rhos * lams * ang, -1)
        dq_dt = torch.sum(rhos * dang, -1)
        ct, st = torch.cos(theta), torch.sin(theta)
        q = q + q2 * cy
        gx = gx + (dq_dr * ct - dq_dt * st / r) * cy
        gz = gz + (dq_dr * st + dq_dt * ct / r) * cy
        gy = gy - k_j * q2 * sy
    return q, torch.stack([gx, gy, gz], -1)
