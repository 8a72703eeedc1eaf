"""Analytic 2D box boundary: closed-form queries for axis-aligned walls.

Port of the wall part of nmcfluid/geometry/analytic2d.py. The Taylor-Green
boundary is a closed square, so every walk-step query is per-axis
arithmetic. Walls are encoded per side (lo_x, lo_y / hi_x, hi_y); normals
point out of the fluid. Circle obstacles and always-silhouette points
(karman) are not ported yet and raise. The walk solver reaches these
functions through `WostScene.qmod()`, which returns this module.
"""
from typing import NamedTuple

import numpy as np
import torch

FAR = 1.0e6
OFFSET_EPS = 3e-5  # stand-in for fcpw's ~256-ULP offsetPointAlongDirection


class Analytic2D(NamedTuple):
    lo: torch.Tensor     # (2,) wall positions, -FAR if open
    hi: torch.Tensor     # (2,) wall positions, +FAR if open
    bmin: torch.Tensor   # (2,) scene bbox (escape test)
    bmax: torch.Tensor

    def to(self, device):
        return Analytic2D(*(t.to(device) for t in self))


def make_analytic2d(lo, hi, circles=(), sil_pts=(), bbox=None,
                    device="cpu"):
    if len(circles) or len(sil_pts):
        raise NotImplementedError("analytic2d: circle obstacles and "
                                  "silhouette points (karman) are not "
                                  "ported yet")
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    if bbox is None:
        bmin = np.where(np.isfinite(lo) & (np.abs(lo) < FAR), lo, -FAR)
        bmax = np.where(np.isfinite(hi) & (np.abs(hi) < FAR), hi, FAR)
    else:
        bmin, bmax = np.asarray(bbox[0]), np.asarray(bbox[1])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Analytic2D(lo=f32(lo), hi=f32(hi), bmin=f32(bmin), bmax=f32(bmax))


def _wall_dists(g: Analytic2D, x):
    """(..., 4): distances to lo_x, lo_y, hi_x, hi_y walls."""
    return torch.cat([x - g.lo, g.hi - x], dim=-1)


def closest_point(g: Analytic2D, x):
    """(dist, signed_dist): signed is negative on the fluid side."""
    dist = torch.amin(torch.abs(_wall_dists(g, x)), dim=-1)
    in_box = torch.all((x >= g.bmin) & (x <= g.bmax), dim=-1)
    sign = torch.where(in_box, -1.0, 1.0)
    return dist, sign * dist


def distance(g: Analytic2D, x):
    return closest_point(g, x)[0]


def signed_distance(g: Analytic2D, x):
    return closest_point(g, x)[1]


def ray_intersect(g: Analytic2D, o, d, t_max):
    """First wall hit within t_max -> (hit, t, point, normal)."""
    eps = 1e-12
    t_best = torch.full_like(t_max, float("inf"))
    n_best = torch.zeros_like(o)
    for axis in range(2):
        other = 1 - axis
        for w, nrm_sign in ((g.lo[axis], -1.0), (g.hi[axis], 1.0)):
            denom = d[..., axis]
            small = torch.abs(denom) < eps
            t = (w - o[..., axis]) / torch.where(small, eps, denom)
            # walls span only the scene bbox along the tangential axis
            tang = o[..., other] + t * d[..., other]
            in_span = (tang >= g.bmin[other] - 1e-6) \
                & (tang <= g.bmax[other] + 1e-6)
            ok = ~small & (t > 0.0) & (torch.abs(w) < FAR) & in_span
            t = torch.where(ok, t, float("inf"))
            better = t < t_best
            t_best = torch.where(better, t, t_best)
            n = torch.zeros_like(o)
            n[..., axis] = nrm_sign
            n_best = torch.where(better[..., None], n, n_best)
    hit = torch.isfinite(t_best) & (t_best <= t_max)
    t_hit = torch.where(hit, t_best, t_max)
    return hit, t_hit, o + t_hit[..., None] * d, n_best


def has_line_of_sight(g: Analytic2D, x, y):
    d = y - x
    ln = torch.linalg.vector_norm(d, dim=-1)
    dn = d / torch.clamp(ln, min=1e-20)[..., None]
    hit, _, _, _ = ray_intersect(g, x, dn, ln * (1.0 - 1e-5))
    return ~hit


def star_radius(g: Analytic2D, x, min_radius, max_radius):
    """Closest silhouette. A box is convex from inside, so it has none:
    the star radius is max_radius (capped at FAR), floored at
    min_radius."""
    return torch.clamp(torch.clamp(max_radius, max=FAR), min=min_radius)


def dist_to_far_bbox_corner(g: Analytic2D, x):
    far = torch.maximum(torch.abs(x - g.bmin), torch.abs(x - g.bmax))
    return torch.linalg.vector_norm(far, dim=-1)


def outside_bbox(g: Analytic2D, x):
    return torch.any((x < g.bmin) | (x > g.bmax), dim=-1)
