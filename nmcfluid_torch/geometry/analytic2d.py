"""Analytic 2D boundary: axis-aligned wall slabs + circle obstacles.

Port of nmcfluid/geometry/analytic2d.py. Every 2D scene the port runs is a
box (Taylor-Green) or an open channel plus circles (the karman family),
so each walk-step query is closed-form:
  * wall distance / ray: per-axis arithmetic;
  * circle distance: | |x-c| - r |; ray-circle: a quadratic;
  * star radius: the closest silhouette of a circle seen from outside is
    its tangent point, at distance sqrt(|x-c|^2 - r^2);
  * open-chain endpoints (the karman walls' corners) are always-silhouette
    points.

Walls are encoded per side (lo_x, lo_y / hi_x, hi_y); +-FAR marks an open
side (karman's inlet and outlet). Normals point out of the fluid. With no
circles and no silhouette points (Taylor-Green) the circle and silhouette
branches are left out when the queries are built, so the box's walk
launches nothing for them. The walk solver reaches these functions through
`WostScene.qmod()`, which returns this module.
"""
from typing import NamedTuple

import numpy as np
import torch

from .sdf import sqrt_rn

FAR = 1.0e6
OFFSET_EPS = 3e-5  # stand-in for fcpw's ~256-ULP offsetPointAlongDirection


class Analytic2D(NamedTuple):
    lo: torch.Tensor       # (2,) wall positions, -FAR if open
    hi: torch.Tensor       # (2,) wall positions, +FAR if open
    circles: torch.Tensor  # (C, 3): cx, cy, r; fluid outside
    sil_pts: torch.Tensor  # (E, 2) always-silhouette points (chain ends)
    bmin: torch.Tensor     # (2,) scene bbox (escape test)
    bmax: torch.Tensor

    def to(self, device):
        return Analytic2D(*(t.to(device) for t in self))


def make_analytic2d(lo, hi, circles=(), sil_pts=(), bbox=None,
                    device="cpu"):
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    if bbox is None:
        bmin = np.where(np.isfinite(lo) & (np.abs(lo) < FAR), lo, -FAR)
        bmax = np.where(np.isfinite(hi) & (np.abs(hi) < FAR), hi, FAR)
    else:
        bmin, bmax = np.asarray(bbox[0]), np.asarray(bbox[1])
    c = np.asarray(circles, np.float64).reshape(-1, 3)
    sp = np.asarray(sil_pts, np.float64).reshape(-1, 2)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Analytic2D(lo=f32(lo), hi=f32(hi), circles=f32(c),
                      sil_pts=f32(sp), bmin=f32(bmin), bmax=f32(bmax))


def _wall_dists(g: Analytic2D, x):
    """(..., 4): distances to lo_x, lo_y, hi_x, hi_y walls."""
    return torch.cat([x - g.lo, g.hi - x], dim=-1)


def closest_point(g: Analytic2D, x):
    """(dist, signed_dist): signed is negative on the fluid side, which is
    inside the bbox and outside every circle."""
    dist = torch.amin(torch.abs(_wall_dists(g, x)), dim=-1)
    in_fluid = torch.all((x >= g.bmin) & (x <= g.bmax), dim=-1)
    if g.circles.shape[0]:
        dc = torch.linalg.vector_norm(x[..., None, :] - g.circles[:, :2],
                                      dim=-1)
        dist = torch.minimum(
            dist, torch.amin(torch.abs(dc - g.circles[:, 2]), dim=-1))
        in_fluid = in_fluid & ~torch.any(dc < g.circles[:, 2], dim=-1)
    sign = torch.where(in_fluid, -1.0, 1.0)
    return dist, sign * dist


def distance(g: Analytic2D, x):
    return closest_point(g, x)[0]


def signed_distance(g: Analytic2D, x):
    return closest_point(g, x)[1]


def ray_intersect(g: Analytic2D, o, d, t_max):
    """First wall or circle hit within t_max -> (hit, t, point, normal)."""
    eps = 1e-12
    t_best = torch.full_like(t_max, float("inf"))
    n_best = torch.zeros_like(o)
    for axis in range(2):
        other = 1 - axis
        for w, nrm_sign in ((g.lo[axis], -1.0), (g.hi[axis], 1.0)):
            denom = d[..., axis]
            small = torch.abs(denom) < eps
            t = (w - o[..., axis]) / torch.where(small, eps, denom)
            # walls span only the scene bbox along the tangential axis:
            # rays through an open side escape
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
    if g.circles.shape[0]:
        oc = o[..., None, :] - g.circles[:, :2]             # (..., C, 2)
        b = torch.sum(oc * d[..., None, :], dim=-1)
        c = torch.sum(oc * oc, dim=-1) - g.circles[:, 2] ** 2
        disc = b * b - c
        sq = sqrt_rn(torch.clamp(disc, min=0.0))
        t1, t2 = -b - sq, -b + sq
        t = torch.where(t1 > 0.0, t1,
                        torch.where(t2 > 0.0, t2, float("inf")))
        t = torch.where(disc >= 0.0, t, float("inf"))
        # the winning circle by argmin and a gather (the JAX package's
        # one-hot weighted sum is a TPU workaround with the same result)
        tc, ic = torch.min(t, dim=-1)
        win = g.circles[ic]                                  # (..., 3)
        pt_c = o + tc[..., None] * d
        # normal toward the center (out of the fluid, into the obstacle)
        n_c = (win[..., :2] - pt_c) / torch.clamp(win[..., 2:], min=1e-20)
        better = tc < t_best
        t_best = torch.where(better, tc, t_best)
        n_best = torch.where(better[..., None], n_c, n_best)
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
    """Closest silhouette: the circles' tangent distances and the
    silhouette points' distances; walls are convex from inside and have
    none. Capped at max_radius (and FAR), floored at min_radius."""
    if not (g.circles.shape[0] or g.sil_pts.shape[0]):
        return torch.clamp(torch.clamp(max_radius, max=FAR), min=min_radius)
    best = torch.full(x.shape[:-1], FAR, dtype=x.dtype, device=x.device)
    if g.circles.shape[0]:
        d2 = torch.sum((x[..., None, :] - g.circles[:, :2]) ** 2, dim=-1)
        tang = torch.sqrt(torch.clamp(d2 - g.circles[:, 2] ** 2, min=0.0))
        best = torch.minimum(best, torch.amin(tang, dim=-1))
    if g.sil_pts.shape[0]:
        dd = torch.linalg.vector_norm(x[..., None, :] - g.sil_pts, dim=-1)
        best = torch.minimum(best, torch.amin(dd, dim=-1))
    r = torch.where(best < max_radius, best, max_radius)
    return torch.clamp(r, min=min_radius)


def dist_to_far_bbox_corner(g: Analytic2D, x):
    far = torch.maximum(torch.abs(x - g.bmin), torch.abs(x - g.bmax))
    return torch.linalg.vector_norm(far, dim=-1)


def outside_bbox(g: Analytic2D, x):
    return torch.any((x < g.bmin) | (x > g.bmax), dim=-1)
