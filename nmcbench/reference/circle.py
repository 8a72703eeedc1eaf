"""The exterior modal correction of a box pressure solve around one circle
obstacle, in the screened Poisson problem (Lap - sigma) p = -f.

The box solve p0 (spectral.py) has Neumann walls on the box only, so it
leaves a normal derivative on the circle r = a. Outside the circle the
homogeneous screened equation separates around the circle's centre into
modes that decay away from it,

    q(r, theta) = sum_m rho_m(r) (A_m cos m theta + B_m sin m theta),
    rho_m(r)    = K_m(sqrt(sigma) r) / K_m(sqrt(sigma) a),

and d/dr (p0 + q) = 0 at r = a is one division a mode:

    A_m, B_m = (the m-th cosine, sine coefficient of -d/dr p0 at r = a)
               / (sqrt(sigma) K'_m(sqrt(sigma) a) / K_m(sqrt(sigma) a)).

The Neumann data is the central-difference grid gradient of p0 looked up
multilinearly at `n_bdry` equispaced angles on the circle, and there are
`n_modes` modes: the definition the method fixes. Everything else is
computed here in float64 in its own way: the coefficients by a plain sum
over the angles, and every K_m (m = 0 ... n_modes) from
scipy.special.kve at each point, K'_m = -(K_{m-1} + K_{m+1}) / 2 with
K_{-1} = K_1. A point inside the circle is evaluated at the circle's
radius (its p is masked or its gradient dropped downstream)."""
import math

import numpy as np
import scipy.special
import torch

from . import spectral


def boundary_data(g_grid, box, center, radius, n_bdry):
    """(theta (n_bdry,), h (n_bdry,)): -d/dr p0 at n_bdry equispaced
    angles on the circle, float64, from the grid gradient g_grid (torch,
    (nx, ny, 2)) by multilinear lookup."""
    theta = 2.0 * math.pi * np.arange(n_bdry) / n_bdry
    ct, st = np.cos(theta), np.sin(theta)
    pts = np.stack([center[0] + radius * ct, center[1] + radius * st], -1)
    g = spectral.lookup(g_grid.double(), box, torch.from_numpy(pts).to(
        g_grid.device)).cpu().numpy()
    return theta, -(g[:, 0] * ct + g[:, 1] * st)


def coefficients(theta, h, radius, sigma, n_modes):
    """(A, B) (n_modes,) float64: the modes whose radial derivative at
    r = radius is h(theta)."""
    n = theta.shape[0]
    m = np.arange(n_modes)
    ang = m[:, None] * theta[None, :]
    scale = np.where(m == 0, 1.0 / n, 2.0 / n)
    h_cos = scale * (np.cos(ang) * h[None, :]).sum(axis=1)
    h_sin = scale * (np.sin(ang) * h[None, :]).sum(axis=1)
    z0 = math.sqrt(sigma) * radius
    k = scipy.special.kve(np.arange(n_modes + 1), z0)
    k_lo = np.concatenate([[k[1]], k[:n_modes - 1]])        # K_{m-1}
    dk = -(k_lo + k[1:n_modes + 1]) / 2.0                   # K'_m
    denom = math.sqrt(sigma) * dk / k[:n_modes]
    return h_cos / denom, h_sin / denom


def evaluate(A, B, pts, center, radius, sigma):
    """(q, grad q) at pts (N, 2) (numpy float64): the modes (A, B) with
    K_m and K'_m taken from scipy at each point's clamped radius."""
    n_modes = A.shape[0]
    dx, dy = pts[:, 0] - center[0], pts[:, 1] - center[1]
    r = np.maximum(np.sqrt(dx * dx + dy * dy), radius)
    theta = np.arctan2(dy, dx)
    rs = math.sqrt(sigma)
    z, z0 = rs * r, rs * radius
    orders = np.arange(n_modes + 1)
    k0 = scipy.special.kve(orders, z0)                       # (M + 1,)
    # K_m(z) / K_m(z0) = kve(m, z) / kve(m, z0) e^(z0 - z)
    decay = np.exp(z0 - z)[:, None]
    kz = scipy.special.kve(orders[None, :], z[:, None]) * decay  # (N, M+1)
    rho = kz[:, :n_modes] / k0[None, :n_modes]
    k_lo = np.concatenate([kz[:, 1:2], kz[:, :n_modes - 1]], axis=1)
    drho = -(k_lo + kz[:, 1:n_modes + 1]) / 2.0 / k0[None, :n_modes]
    m = np.arange(n_modes)
    cos_mt, sin_mt = np.cos(np.outer(theta, m)), np.sin(np.outer(theta, m))
    ang = A[None, :] * cos_mt + B[None, :] * sin_mt
    dang = m[None, :] * (B[None, :] * cos_mt - A[None, :] * sin_mt)
    q = (rho * ang).sum(axis=1)
    dq_dr = rs * (drho * ang).sum(axis=1)
    dq_dt = (rho * dang).sum(axis=1)
    ct, st = np.cos(theta), np.sin(theta)
    return q, np.stack([dq_dr * ct - dq_dt * st / r,
                        dq_dr * st + dq_dt * ct / r], -1)


def correction(g_grid, box, pts, center, radius, sigma, n_modes=32,
               n_bdry=512, block=1 << 15):
    """(q, grad q) at pts (torch (N, 2), on its device, float64) of the
    circle's correction to the box solve whose grid gradient is g_grid."""
    theta, h = boundary_data(g_grid, box, center, radius, n_bdry)
    A, B = coefficients(theta, h, radius, sigma, n_modes)
    y = pts.detach().double().cpu().numpy()
    qs, gs = [], []
    for a in range(0, y.shape[0], block):
        q, g = evaluate(A, B, y[a:a + block], center, radius, sigma)
        qs.append(q)
        gs.append(g)
    return (torch.from_numpy(np.concatenate(qs)).to(pts.device),
            torch.from_numpy(np.concatenate(gs)).to(pts.device))
