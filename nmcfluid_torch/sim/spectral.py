"""Deterministic screened-Poisson grid solver by cosine transforms (port of
nmcfluid/sim/spectral.py).

Solves (Lap - sigma) p = -f on the cell-centered grid over the scene box
with zero-Neumann walls: the cosine basis diagonalizes the Neumann
Laplacian, so the solve is a DCT-II along each axis, a pointwise divide
and the inverse. PyTorch has no DCT, so `dct_ortho` / `idct_ortho` build
the orthonormal DCT-II and its inverse (the DCT-III) from one N-point
complex FFT each (Makhoul's even/odd reorder and a quarter-sample
twiddle), matching jax.scipy.fft.dct(type=2, norm="ortho") and idct.
"""
import math

import torch


def _twiddle(n, device, sign):
    k = torch.arange(n, dtype=torch.float64, device=device)
    return torch.polar(torch.ones_like(k), sign * math.pi * k / (2.0 * n)) \
        .to(torch.complex64)


def _scale(n, device):
    s = torch.full((n,), math.sqrt(2.0 / n), dtype=torch.float32,
                   device=device)
    s[0] = math.sqrt(1.0 / n)
    return s


def dct_ortho(x, dim):
    """Orthonormal DCT-II of float32 `x` along `dim`: X[k] = s_k sum_n
    x[n] cos(pi k (2n + 1) / (2N)), s_0 = sqrt(1/N), s_k = sqrt(2/N)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    # v = x[0], x[2], ..., then the odd samples backwards
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
    V = torch.fft.fft(v, dim=-1)
    out = (V * _twiddle(n, x.device, -1.0)).real * _scale(n, x.device)
    return out.movedim(-1, dim)


def idct_ortho(X, dim):
    """Inverse of `dct_ortho` along `dim` (the orthonormal DCT-III)."""
    X = X.movedim(dim, -1)
    n = X.shape[-1]
    # C[k] = sum_n x[n] cos(pi k (2n + 1) / (2N)), with C[N] = 0
    C = X / _scale(n, X.device)
    C_rev = torch.cat([torch.zeros_like(C[..., :1]),
                       C[..., 1:].flip(-1)], dim=-1)     # C[N - k]
    V = torch.complex(C, -C_rev) * _twiddle(n, X.device, 1.0)
    v = torch.fft.ifft(V, dim=-1).real
    x = torch.empty_like(v)
    half = (n + 1) // 2
    x[..., 0::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x.movedim(-1, dim)


def solve_screened_poisson(f, scene_size, sigma: float):
    """p on the cell-centered grid of f (res_x, res_y[, res_z]) with
    (Lap - sigma) p = -f and Neumann walls; pass the grid handed to the
    walk (-div u) to get the same p. sigma = 0 pins the k = 0 mode (zero
    mean)."""
    dim = f.ndim
    g = f
    for ax in range(dim):
        g = dct_ortho(g, ax)
    # eigenvalues of the Neumann Laplacian for the cosine modes
    lam = torch.zeros((), dtype=torch.float32, device=f.device)
    for ax in range(dim):
        n = f.shape[ax]
        L = scene_size[2 * ax + 1] - scene_size[2 * ax]
        k = torch.arange(n, dtype=torch.float32, device=f.device)
        w = (2.0 * n / L * torch.sin(math.pi * k / (2.0 * n))) ** 2
        shape = [1] * dim
        shape[ax] = n
        lam = lam + w.reshape(shape)
    denom = -(lam + sigma)
    if sigma == 0.0:
        denom = denom.clone()
        denom[(0,) * dim] = -1.0
        g = g.clone()
        g[(0,) * dim] = 0.0
    p = -g / denom
    for ax in range(dim):
        p = idct_ortho(p, ax)
    return p


def grid_gradient(p, scene_size):
    """Central-difference gradient of a cell-centered grid, one-sided in
    the first and last cells of each axis. Returns (..., dim)."""
    dim = p.ndim
    out = []
    for ax in range(dim):
        n = p.shape[ax]
        h = (scene_size[2 * ax + 1] - scene_size[2 * ax]) / n
        g = (torch.roll(p, -1, ax) - torch.roll(p, 1, ax)) / (2.0 * h)
        first = (p.select(ax, 1) - p.select(ax, 0)) / h
        last = (p.select(ax, n - 1) - p.select(ax, n - 2)) / h
        g.select(ax, 0).copy_(first)
        g.select(ax, n - 1).copy_(last)
        out.append(g)
    return torch.stack(out, dim=-1)
