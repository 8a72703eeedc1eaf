"""The geometry of an axis-aligned box scene (Taylor-Green's square, the
smoke cube), from the published scenes: the shared helpers that a box
configuration's reference (configs/<name>.py) names as its own.

Each velocity component is multiplied by its own axis's linear
no-through-flow ramp min(clamp(|x - lo|, 0, eps), clamp(|x - hi|, 0,
eps)) / eps; every point of the box is fluid; a back trace is clamped
to the box; the pressure is the screened Poisson solve with Neumann
walls on the box (spectral.py), masked by the distance to the nearest
wall."""
import numpy as np
import torch

from . import spectral


def _box(cfg):
    return cfg["scene_fields"]["scene_size"]


def ramps(x, box, eps):
    """(..., D) ramp of each component along its own axis."""
    out = []
    for i in range(x.shape[-1]):
        lo, hi = box[2 * i], box[2 * i + 1]
        c = x[..., i]
        out.append(torch.minimum(torch.clamp(torch.abs(c - lo), 0.0, eps),
                                 torch.clamp(torch.abs(c - hi), 0.0, eps))
                   / eps)
    return torch.stack(out, dim=-1)


def fluid_mask(x, cfg):
    """(inside, band): every point of the box is fluid, and none lies
    where float32 and float64 may decide it differently."""
    none = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    return ~none, none


def clamp_back(x, cfg):
    """A back-traced point clamped into the box."""
    box, dim = _box(cfg), x.shape[-1]
    lo = torch.tensor(box[0::2][:dim], dtype=x.dtype, device=x.device)
    hi = torch.tensor(box[1::2][:dim], dtype=x.dtype, device=x.device)
    return torch.maximum(torch.minimum(x, hi), lo)


def wall_distance(x, cfg):
    """(unsigned distance to the nearest wall, whether x is outside)."""
    box = _box(cfg)
    d, outside = None, None
    for i in range(x.shape[-1]):
        lo, hi = box[2 * i], box[2 * i + 1]
        c = x[..., i]
        di = torch.minimum(torch.abs(c - lo), torch.abs(c - hi))
        oi = (c <= lo) | (c >= hi)
        d = di if d is None else torch.minimum(d, di)
        outside = oi if outside is None else outside | oi
    return d, outside


def pressure(div_grid, pts, cfg, prec_dtype):
    """(p, grad p) at pts (N, D), unmasked: the screened Poisson solve of
    div_grid (its right-hand side -div u) with Neumann walls on the box,
    multilinear at pts, in `prec_dtype` (torch.float64 or float32)."""
    box = _box(cfg)
    np_dt = np.float64 if prec_dtype == torch.float64 else np.float32
    f = div_grid.detach().cpu().numpy().astype(np_dt)
    pg = spectral.solve(f, box, cfg["scene_fields"]["absorption"])
    gg = spectral.gradient(pg, box)
    y = pts.to(prec_dtype)
    pgt = torch.from_numpy(np.ascontiguousarray(pg)).to(y.device, prec_dtype)
    ggt = torch.from_numpy(np.ascontiguousarray(gg)).to(y.device, prec_dtype)
    return spectral.lookup(pgt, box, y), spectral.lookup(ggt, box, y)
