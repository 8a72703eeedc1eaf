"""Differential operators on coordinate-network fields by forward-mode AD
(port of nmcfluid/ops/diff_ops.py).

The JAX package maps a per-point `f: (dim,) -> (out,)` with vmap(jacfwd).
Here `f` takes a batch of points (n, dim) -> (n, out) or (n,) — the port's
fields are batched — and each operator takes one `torch.func.jvp` per
input axis, over chunks of points, so no graph is kept and memory stays
bounded on large grids. Each takes x of shape (..., dim).
"""
import torch

CHUNK = 1 << 18


def _columns(f, x):
    """[df/dx_d for each input axis d], each (..., out) or (...,)."""
    dim = x.shape[-1]
    flat = x.reshape(-1, dim)
    cols = [[] for _ in range(dim)]
    with torch.no_grad():
        for xc in flat.split(CHUNK):
            for d in range(dim):
                tan = torch.zeros_like(xc)
                tan[:, d] = 1.0
                cols[d].append(torch.func.jvp(f, (xc,), (tan,))[1])
    out = []
    for c in cols:
        c = torch.cat(c)
        out.append(c.reshape(x.shape[:-1] + c.shape[1:]))
    return out


def jacobian(f, x):
    """Per-point Jacobian of f. x: (..., dim) -> (..., out, dim)."""
    return torch.stack(_columns(f, x), dim=-1)


def divergence(f, x):
    """div f at x; f maps (n, dim) -> (n, dim). Returns (...,)."""
    cols = _columns(f, x)
    div = cols[0][..., 0]
    for d in range(1, len(cols)):
        div = div + cols[d][..., d]
    return div


def curl2d(f, x):
    """Scalar vorticity dv/dx - du/dy; f maps (n, 2) -> (n, 2)."""
    dx, dy = _columns(f, x)
    return dx[..., 1] - dy[..., 0]


def curl3d(f, x):
    """Vector vorticity of a 3D field; f maps (n, 3) -> (n, 3)."""
    dx, dy, dz = _columns(f, x)
    return torch.stack([dy[..., 2] - dz[..., 1],
                        dz[..., 0] - dx[..., 2],
                        dx[..., 1] - dy[..., 0]], dim=-1)


def gradient(f, x):
    """Gradient of a scalar field; f maps (n, dim) -> (n,) or (n, 1).
    Returns (..., dim)."""
    return torch.stack([c.reshape(x.shape[:-1]) for c in _columns(f, x)],
                       dim=-1)


def laplacian(f, x):
    """Laplacian of a scalar field by nested forward mode: one jvp of a jvp
    along each input axis, summed; f maps (n, dim) -> (n,) or (n, 1).
    Returns (...,)."""
    dim = x.shape[-1]
    flat = x.reshape(-1, dim)
    out = []
    with torch.no_grad():
        for xc in flat.split(CHUNK):
            lap = torch.zeros(xc.shape[0], dtype=xc.dtype, device=xc.device)
            for d in range(dim):
                tan = torch.zeros_like(xc)
                tan[:, d] = 1.0

                def df(y, tan=tan):
                    return torch.func.jvp(f, (y,), (tan,))[1]
                lap = lap + torch.func.jvp(df, (xc,), (tan,))[1].reshape(-1)
            out.append(lap)
    return torch.cat(out).reshape(x.shape[:-1])
