"""Plain reference of the karman configuration: the open channel (walls at
the two y ends, inlet and outlet open) around one circle, the published
Karman vortex street (Neural-Monte-Carlo-Fluid-Simulation
examples/karman/run.sh, src/2d/models/base.py:169-180): the inlet band
x in [x0, x0 + eps] set to the inflow speed, the velocity ramped off the
circle grown by the mask distance, the y component ramped off the y
walls. The pressure is the box's screened Poisson solve (reference/box.py
and spectral.py) plus the circle's exterior modal correction
(reference/circle.py), which cancels the box solve's normal derivative on
the circle.

Where this reference departs from the plain mathematics, as the program's
method does:
  - a point inside the circle takes the correction at the circle's
    radius (the method clamps the radius; its p is masked near the wall
    and its gradient dropped as outside the domain);
  - within BAND = 1e-6 of the inlet band's edge (x0 + eps rounded to
    float32, as the method adds them) and of the grown circle, float32
    and float64 may classify a point differently: there the inlet
    value is marked as drawn, and the fluid mask defers to the program's.
No product here is a float32 matrix product that TF32 could round: the
box solve runs in numpy, the lookups are elementwise and the correction
runs in float64. The frame's products elsewhere run under
reference/precision.py's `matmul`, which keeps TF32 off but in the
control."""
import numpy as np
import torch

from nmcbench.reference import box, circle, spectral
from nmcbench.reference.box import clamp_back  # noqa: F401

BAND = 1e-6
N_MODES = 32
N_BDRY = 512


def _circle(x, cfg):
    c = cfg["scene_fields"]["obstacle_center"]
    return torch.sqrt((x[..., 0] - c[0]) ** 2 + (x[..., 1] - c[1]) ** 2)


def _grown_sdf(x, cfg):
    sf = cfg["scene_fields"]
    return _circle(x, cfg) - (sf["obstacle_radius"]
                              + sf["boundary_distance_mask"])


def affine(x, cfg, eps, t):
    """(A, c, drawn): u = A raw + c at x; `drawn` marks the points within
    BAND of the inlet band's edge, where float32 may decide either way."""
    sf = cfg["scene_fields"]
    lo = sf["scene_size"][0]
    edge = float(np.float32(lo) + np.float32(eps))
    inlet = (x[..., 0] >= lo) & (x[..., 0] <= edge)
    s = torch.clamp(_grown_sdf(x, cfg), 0.0, eps) / eps
    wy = box.ramps(x, sf["scene_size"], eps)[..., 1]
    A = torch.diag_embed(torch.stack([torch.where(inlet, 0.0, s), s * wy],
                                     dim=-1))
    c = torch.stack([torch.where(inlet, sf["karman_vel"] * s, 0.0),
                     torch.zeros_like(s)], dim=-1)
    return A, c, torch.abs(x[..., 0] - edge) < BAND


def fluid_mask(x, cfg):
    d = _grown_sdf(x, cfg)
    return d > 0.0, torch.abs(d) < BAND


def wall_distance(x, cfg):
    """Distance to the y walls and the circle (the inlet and outlet are
    open); outside is past a y wall or inside the circle."""
    sf = cfg["scene_fields"]
    _, _, y0, y1 = sf["scene_size"]
    dc = _circle(x, cfg)
    d = torch.minimum(torch.minimum(torch.abs(x[..., 1] - y0),
                                    torch.abs(y1 - x[..., 1])),
                      torch.abs(dc - sf["obstacle_radius"]))
    outside = (x[..., 1] < y0) | (x[..., 1] > y1) \
        | (dc < sf["obstacle_radius"])
    return d, outside


def pressure(div_grid, pts, cfg, prec_dtype):
    """(p, grad p) at pts (N, 2), unmasked: the box's screened Poisson
    solve of div_grid with Neumann walls on the box, multilinear at pts,
    plus the circle's modal correction (float64 whatever prec_dtype: its
    Bessel functions overflow float32), in `prec_dtype`."""
    sf = cfg["scene_fields"]
    box_ = sf["scene_size"]
    np_dt = np.float64 if prec_dtype == torch.float64 else np.float32
    f = div_grid.detach().cpu().numpy().astype(np_dt)
    sigma = sf["absorption"]
    pg = spectral.solve(f, box_, sigma)
    gg = spectral.gradient(pg, box_)
    y = pts.to(prec_dtype)
    pgt = torch.from_numpy(np.ascontiguousarray(pg)).to(y.device, prec_dtype)
    ggt = torch.from_numpy(np.ascontiguousarray(gg)).to(y.device, prec_dtype)
    p, g = spectral.lookup(pgt, box_, y), spectral.lookup(ggt, box_, y)
    if sigma > 0.0:
        q, gq = circle.correction(ggt, box_, y, sf["obstacle_center"],
                                  sf["obstacle_radius"], sigma, N_MODES,
                                  N_BDRY)
        p, g = p + q.to(prec_dtype), g + gq.to(prec_dtype)
    return p, g
