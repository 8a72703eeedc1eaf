"""Exterior screened-harmonic (modified spherical Bessel) sphere correction
(port of nmcfluid/ops/sphere_modes.py), for smoke_obs under the spectral
projection.

The box solve p0 leaves a normal-derivative residual dp0/dr on the
obstacle sphere; the homogeneous screened equation separates around its
centre into exterior-decaying modes

    q(r, Omega) = sum_{l,m} c_lm rho_l(r) Y_lm(Omega),
    rho_l(r)    = k_l(sqrt(sigma) r) / k_l(sqrt(sigma) a),

with k_l the modified spherical Bessel function of the second kind and
Y_lm the real orthonormal spherical harmonics: one diagonal solve per
mode.

- k_l(z) = (pi / (2z)) e^{-z} P_l(1/z), P_l(u) = sum_k (l+k)!/(k!(l-k)!
  2^k) u^k, so rho_l(r) = (z0/z) e^{z0-z} P_l(1/z) / P_l(1/z0), with the
  float64 host coefficients b_lk = a_lk / P_l(1/z0): every term of the
  float32 polynomial is <= 1 outside the sphere.
- Y_lm by the fully normalized associated-Legendre recurrences.
- grad q by autograd of the closed-form field: the points are
  independent, so one backward pass of the summed field gives every
  point's gradient (no hand-derived angular derivatives).
- s_l = k_l'(z0)/k_l(z0) on the host in float64 from scipy's kve at
  half-integer order.
"""
import math

import numpy as np
import scipy.special as _sps
import torch

from ..geometry.sdf import sqrt_rn


def _poly_consts(z0: float, n_l: int):
    """Float64: b[l][k] = a_lk / P_l(1/z0) and s[l] = k_l'(z0)/k_l(z0)."""
    bs = []
    for l in range(n_l):
        a = np.array([math.factorial(l + k)
                      / (math.factorial(k) * math.factorial(l - k)
                         * 2.0 ** k) for k in range(l + 1)])
        p_z0 = float(np.sum(a * z0 ** (-np.arange(l + 1))))
        bs.append((a / p_z0).astype(np.float64))
    nu = np.arange(n_l) + 0.5
    kv_m = _sps.kve(nu - 1.0, z0)
    kv_0 = _sps.kve(nu, z0)
    kv_p = _sps.kve(nu + 1.0, z0)
    # k_l'/k_l = K'_nu/K_nu - 1/(2 z0),  K'_nu = -(K_{nu-1}+K_{nu+1})/2
    s = -(kv_m + kv_p) / (2.0 * kv_0) - 1.0 / (2.0 * z0)
    return bs, s


def _rho(z, z0, bs):
    """rho_l(z) for every l: (N, L)."""
    zi = 1.0 / z
    pref = (z0 / z) * torch.exp(z0 - z)
    cols = []
    for b in bs:
        acc = torch.zeros_like(z) + float(b[-1])
        for c in b[-2::-1]:
            acc = acc * zi + float(c)
        cols.append(pref * acc)
    return torch.stack(cols, -1)


def _real_sph_harm(ct, st, phi, n_l):
    """Real orthonormal Y_lm for l < n_l: (N, n_l^2), column l^2 + (m + l)
    for m in [-l, l] (negative m: the sine harmonics)."""
    P = {(0, 0): torch.full_like(ct, 1.0 / math.sqrt(4.0 * math.pi))}
    for m in range(1, n_l):
        P[(m, m)] = (-math.sqrt((2 * m + 1) / (2.0 * m))
                     * st * P[(m - 1, m - 1)])
    for m in range(0, n_l - 1):
        P[(m + 1, m)] = math.sqrt(2 * m + 3) * ct * P[(m, m)]
    for m in range(0, n_l):
        for l in range(m + 2, n_l):
            a = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = math.sqrt(((l - 1.0) ** 2 - m * m)
                          / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[(l, m)] = a * (ct * P[(l - 1, m)] - b * P[(l - 2, m)])
    cos_m = [torch.ones_like(phi)]
    sin_m = [torch.zeros_like(phi)]
    for m in range(1, n_l):
        cos_m.append(torch.cos(m * phi))
        sin_m.append(torch.sin(m * phi))
    cols = []
    r2 = math.sqrt(2.0)
    for l in range(n_l):
        for m in range(-l, l + 1):
            base = P[(l, abs(m))]
            if m == 0:
                cols.append(base)
            elif m > 0:
                cols.append(r2 * base * cos_m[m])
            else:
                cols.append(r2 * base * sin_m[-m])
    return torch.stack(cols, -1)


def _lidx(n_l):
    return np.concatenate([[l] * (2 * l + 1) for l in range(n_l)])


def _q_field(x, coeffs, center, radius, sigma, n_l, bs):
    """q at each point of x (N, 3)."""
    rs = math.sqrt(sigma)
    z0 = rs * radius
    d = x - torch.tensor(center, dtype=x.dtype, device=x.device)
    r = torch.clamp(sqrt_rn(torch.sum(d * d, -1)), min=radius)
    ct = torch.clamp(d[:, 2] / r, -1.0, 1.0)
    st = sqrt_rn(torch.clamp(1.0 - ct * ct, min=1e-12))
    phi = torch.atan2(d[:, 1], d[:, 0] + 1e-30)
    rho = _rho(rs * r, z0, bs)                                # (N, L)
    Y = _real_sph_harm(ct, st, phi, n_l)                      # (N, L^2)
    lidx = torch.as_tensor(_lidx(n_l), device=x.device)
    return torch.sum(coeffs * rho[:, lidx] * Y, -1)


def eval_sphere_correction(coeffs, pts, center, radius, sigma, n_l=12):
    """(q, grad q) at pts (N, 3). Points inside the sphere evaluate at the
    clamped radius; the boundary masking zeroes them downstream."""
    z0 = math.sqrt(sigma) * radius
    bs, _ = _poly_consts(z0, n_l)
    with torch.enable_grad():
        x = pts.detach().requires_grad_(True)
        q = _q_field(x, coeffs.detach(), center, radius, sigma, n_l, bs)
        g, = torch.autograd.grad(q.sum(), x)
    return q.detach(), g


def fit_sphere_correction(g_grid, scene_size, center, radius, sigma,
                          n_l=12, n_theta=24, n_phi=48):
    """c_lm cancelling the sphere's Neumann residual of a box solve;
    g_grid (res, res, res, 3) is the box solution's gradient on the
    cell-centered grid. Gauss-Legendre x uniform-phi quadrature projects
    h = -dp0/dr onto Y_lm; the diagonal solve divides by sqrt(sigma) *
    k_l'(z0)/k_l(z0)."""
    from ..sim.sampling import bilinear_lookup
    dev = g_grid.device
    f32 = dict(dtype=torch.float32, device=dev)
    z0 = math.sqrt(sigma) * radius
    _, s = _poly_consts(z0, n_l)
    xg, wg = np.polynomial.legendre.leggauss(n_theta)
    ct = torch.tensor(np.repeat(xg, n_phi).astype(np.float32), device=dev)
    w = torch.tensor(np.repeat(wg, n_phi).astype(np.float32), device=dev) \
        * (2.0 * math.pi / n_phi)
    phi = torch.tensor(np.tile(np.arange(n_phi) * 2.0 * math.pi / n_phi,
                               n_theta).astype(np.float32), device=dev)
    st = sqrt_rn(torch.clamp(1.0 - ct * ct, min=0.0))
    nrm = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    pts = torch.tensor(center, **f32) + radius * nrm
    g = torch.stack([bilinear_lookup(g_grid[..., i], scene_size, pts)
                     for i in range(3)], -1)
    h = -torch.sum(g * nrm, -1)
    Y = _real_sph_harm(ct, st, phi, n_l)                      # (B, L^2)
    h_lm = (w * h) @ Y
    denom = math.sqrt(sigma) * torch.tensor(s, **f32)[
        torch.as_tensor(_lidx(n_l), device=dev)]
    return h_lm / denom
