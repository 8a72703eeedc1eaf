"""The screened Poisson problem (Lap - sigma) p = -f with zero-Neumann
walls on a cell-centred grid over a box, solved in the cosine basis (the
five-point Neumann Laplacian's eigenvectors) with SciPy's orthonormal
DCT-II/III, and its gradient and multilinear lookup at points."""
import numpy as np
import scipy.fft
import torch


def solve(f, box, sigma):
    """p (numpy, the dtype of f) on the grid of f; sigma = 0 takes the
    solution of zero mean."""
    g = scipy.fft.dctn(f, type=2, norm="ortho")
    lam = np.zeros((), f.dtype)
    for ax in range(f.ndim):
        n = f.shape[ax]
        h = (box[2 * ax + 1] - box[2 * ax]) / n
        k = np.arange(n, dtype=f.dtype)
        w = (2.0 / h * np.sin(np.pi * k / (2.0 * n))) ** 2
        shape = [1] * f.ndim
        shape[ax] = n
        lam = lam + w.reshape(shape)
    denom = lam + sigma
    if sigma == 0.0:
        denom[(0,) * f.ndim] = 1.0
        g[(0,) * f.ndim] = 0.0
    return scipy.fft.idctn(g / denom, type=2, norm="ortho")


def gradient(p, box):
    """Central differences, one-sided in the first and last cell of each
    axis: (..., D)."""
    out = []
    for ax in range(p.ndim):
        n = p.shape[ax]
        h = (box[2 * ax + 1] - box[2 * ax]) / n
        g = np.empty_like(p)
        mid = [slice(None)] * p.ndim
        up, dn = list(mid), list(mid)
        mid[ax], up[ax], dn[ax] = slice(1, n - 1), slice(2, n), slice(0, n - 2)
        g[tuple(mid)] = (p[tuple(up)] - p[tuple(dn)]) / (2.0 * h)
        for i, (a, b) in ((0, (1, 0)), (n - 1, (n - 1, n - 2))):
            s, ia, ib = list(mid), list(mid), list(mid)
            s[ax], ia[ax], ib[ax] = i, a, b
            g[tuple(s)] = (p[tuple(ia)] - p[tuple(ib)]) / h
        out.append(g)
    return np.stack(out, axis=-1)


def lookup(grid, box, y):
    """Multilinear interpolation of a cell-centred grid (torch, on y's
    device) at points y (N, D), clamped to the outer cells' centres."""
    D = y.shape[-1]
    res = grid.shape[:D]
    out = 0.0
    i0s, ws = [], []
    for i in range(D):
        lo, hi = box[2 * i], box[2 * i + 1]
        u = (y[:, i] - lo) / (hi - lo) * res[i] - 0.5
        i0 = torch.clamp(torch.floor(u).long(), 0, res[i] - 2)
        i0s.append(i0)
        ws.append(torch.clamp(u - i0.to(u.dtype), 0.0, 1.0))
    for corner in range(1 << D):
        idx, w = [], 1.0
        for i in range(D):
            bit = (corner >> i) & 1
            idx.append(i0s[i] + bit)
            w = w * (ws[i] if bit else 1.0 - ws[i])
        v = grid[tuple(idx)]
        out = out + (w[:, None] * v if v.ndim == 2 else w * v)
    return out
