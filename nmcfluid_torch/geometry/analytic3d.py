"""Analytic 3D boundary: a closed axis-aligned box.

Port of nmcfluid/geometry/analytic3d.py. Every shipped 3D scene walks the
cube [-1, 1]^3 (examples/*/cube.obj); obstacles enter only through the
hard boundary conditions, not the walk geometry. Seen from inside, the box
is convex, so it has no silhouettes: the star radius is the one the caller
caps it at, and a ray leaves through the nearest wall (the slab test).
Normals point out of the fluid. The walk solver and the fluid reach these
functions through queries3d, which hands a Box3D boundary to this module
and walks triangle soups itself.
"""
from typing import NamedTuple

import numpy as np
import torch

OFFSET_EPS = 3e-5  # stand-in for fcpw's ~256-ULP offsetPointAlongDirection


class Box3D(NamedTuple):
    bmin: torch.Tensor   # (3,)
    bmax: torch.Tensor   # (3,)

    def to(self, device):
        return Box3D(*(t.to(device) for t in self))


def make_box3d(bmin, bmax, device="cpu"):
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Box3D(bmin=f32(bmin), bmax=f32(bmax))


def closest_point(g: Box3D, x):
    """(dist, signed_dist): signed is negative inside the box."""
    d = torch.minimum(torch.abs(x - g.bmin), torch.abs(g.bmax - x))
    dist = torch.amin(d, dim=-1)
    in_box = torch.all((x >= g.bmin) & (x <= g.bmax), dim=-1)
    return dist, torch.where(in_box, -1.0, 1.0) * dist


def distance(g: Box3D, x):
    return closest_point(g, x)[0]


def signed_distance(g: Box3D, x):
    return closest_point(g, x)[1]


def ray_intersect(g: Box3D, o, d, t_max):
    """Nearest wall hit with t > 0 within t_max -> (hit, t, point,
    normal); from inside, the exit point."""
    eps = 1e-12
    t_best = torch.full_like(t_max, float("inf"))
    n_best = torch.zeros_like(o)
    for axis in range(3):
        for w, nrm_sign in ((g.bmin[axis], -1.0), (g.bmax[axis], 1.0)):
            denom = d[..., axis]
            small = torch.abs(denom) < eps
            t = (w - o[..., axis]) / torch.where(small, eps, denom)
            t = torch.where(~small & (t > 0.0), t, float("inf"))
            better = t < t_best
            t_best = torch.where(better, t, t_best)
            n = torch.zeros_like(o)
            n[..., axis] = nrm_sign
            n_best = torch.where(better[..., None], n, n_best)
    hit = torch.isfinite(t_best) & (t_best <= t_max)
    t_hit = torch.where(hit, t_best, t_max)
    return hit, t_hit, o + t_hit[..., None] * d, n_best


def star_radius(g: Box3D, x, min_radius, max_radius):
    """No silhouettes: max_radius, floored at min_radius."""
    return torch.clamp(max_radius.expand(x.shape[:-1]), min=min_radius)


def dist_to_far_bbox_corner(g: Box3D, x):
    far = torch.maximum(torch.abs(x - g.bmin), torch.abs(x - g.bmax))
    return torch.linalg.vector_norm(far, dim=-1)


def outside_bbox(g: Box3D, x):
    return torch.any((x < g.bmin) | (x > g.bmax), dim=-1)
