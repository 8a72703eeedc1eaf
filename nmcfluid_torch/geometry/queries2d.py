"""Brute-force geometric queries over 2D segment soups (port of
nmcfluid/geometry/queries2d.py).

Each query broadcasts a batch of points x (..., 2) against the padded
segments (P, 2) of a Seg2D and reduces over them (the role of FCPW's
GeometricQueries<2>, geometric_queries.h:42-71). Where the JAX package
selects the winning segment by a one-hot weighted sum (a TPU workaround
for per-lane gathers), this port takes argmin and a gather: the same
winner, ties to the lowest index, as jnp.argmin. Analytic2D boundaries
(Taylor-Green, the karman family) go to their closed-form queries in
analytic2d, so their walks stay as they are.
"""
import torch

from . import analytic2d
from .analytic2d import Analytic2D
from .sdf import sqrt_rn
from .soup2d import FAR, Seg2D  # noqa: F401  (Seg2D re-exported)

OFFSET_EPS = 3e-5  # stand-in for fcpw's ~256-ULP offsetPointAlongDirection


def _dispatch(fn):
    """Route Analytic2D boundaries to analytic2d's query of the same name;
    segment soups take the brute-force path below."""
    afn = getattr(analytic2d, fn.__name__, None)

    def wrapper(soup, *a, **kw):
        if isinstance(soup, Analytic2D):
            return afn(soup, *a, **kw)
        return fn(soup, *a, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _take(table, idx):
    """table[idx] for a (P, C) table and (...,) indices -> (..., C)."""
    return table[idx.reshape(-1)].reshape(idx.shape + table.shape[1:])


@_dispatch
def closest_point(soup: Seg2D, x):
    """(dist, signed_dist, point, normal) of the closest boundary point;
    signed_dist is negative on the fluid side (the normals point out of
    it), as fcpw's Interaction::signedDistance. Analytic2D boundaries
    return (dist, signed_dist) only."""
    a, b = soup.a, soup.b                         # (P, 2)
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, -1), min=1e-20)
    xa = x[..., None, :] - a                      # (..., P, 2)
    t = torch.clamp(torch.sum(xa * ab, -1) / denom, 0.0, 1.0)
    p = a + t[..., None] * ab                     # (..., P, 2)
    d2 = torch.sum((x[..., None, :] - p) ** 2, -1)
    i = torch.argmin(d2, dim=-1)
    dist = sqrt_rn(torch.gather(d2, -1, i[..., None])[..., 0])
    pt = torch.gather(p, -2, i[..., None, None].expand(
        i.shape + (1, 2)))[..., 0, :]
    nrm = _take(soup.n, i)
    sign = torch.where(torch.sum((x - pt) * nrm, -1) < 0.0, -1.0, 1.0)
    return dist, sign * dist, pt, nrm


def distance(soup, x):
    return closest_point(soup, x)[0]


def signed_distance(soup, x):
    return closest_point(soup, x)[1]


def inside(soup, x):
    """insideDomain: the sign of the signed distance
    (fcpw_scene_loader.h:642-648)."""
    return signed_distance(soup, x) < 0.0


@_dispatch
def ray_intersect(soup: Seg2D, o, d, t_max):
    """First hit of the rays o + t d, 0 < t <= t_max, against the soup:
    (hit, t, point, normal) with the segment's stored normal (fcpw's
    Interaction for line segments)."""
    a, b = soup.a, soup.b
    ab = b - a                                     # (P, 2)
    ao = a - o[..., None, :]                       # (..., P, 2)
    dxab = d[..., None, 0] * ab[..., 1] - d[..., None, 1] * ab[..., 0]
    small = torch.abs(dxab) < 1e-12
    safe = torch.where(small, 1.0, dxab)
    t = (ao[..., 0] * ab[..., 1] - ao[..., 1] * ab[..., 0]) / safe
    s = (ao[..., 0] * d[..., None, 1] - ao[..., 1] * d[..., None, 0]) / safe
    ok = (~small & (s >= 0.0) & (s <= 1.0) & (t > 0.0)
          & (t <= t_max[..., None]))
    t = torch.where(ok, t, float("inf"))
    i = torch.argmin(t, dim=-1)
    t_hit = torch.gather(t, -1, i[..., None])[..., 0]
    nrm = _take(soup.n, i)
    hit = torch.isfinite(t_hit)
    t_hit = torch.where(hit, t_hit, t_max)
    return hit, t_hit, o + t_hit[..., None] * d, nrm


@_dispatch
def has_line_of_sight(soup: Seg2D, x, y):
    """True where the open segment x -> y crosses no boundary segment
    (fcpw Aggregate::hasLineOfSight)."""
    d = y - x
    ln = sqrt_rn(torch.sum(d * d, -1))
    dn = d / torch.clamp(ln, min=1e-20)[..., None]
    hit, _, _, _ = ray_intersect(soup, x, dn, ln * (1.0 - 1e-5))
    return ~hit


@_dispatch
def star_radius(soup: Seg2D, x, min_radius, max_radius):
    """Distance to the closest silhouette vertex, else max_radius, floored
    at min_radius (computeStarRadius, fcpw_scene_loader.h:621-641): a
    vertex is a silhouette from x when its two segments face opposite
    sides of x, and always for an open-chain endpoint."""
    if soup.sv.shape[0] == 0:
        return torch.clamp(max_radius, min=min_radius)
    xv = x[..., None, :] - soup.sv                 # (..., V, 2)
    d1 = torch.sum(xv * soup.sn1, -1)
    d2 = torch.sum(xv * soup.sn2, -1)
    is_sil = (d1 * d2 <= 0.0) | soup.s_always
    dist = sqrt_rn(torch.sum(xv * xv, -1))
    dist = torch.where(is_sil, dist, FAR)
    closest = torch.amin(dist, dim=-1)
    r = torch.where(closest < max_radius, closest, max_radius)
    return torch.clamp(r, min=min_radius)


@_dispatch
def dist_to_far_bbox_corner(soup: Seg2D, x):
    """zombie's distance to Dirichlet without a Dirichlet boundary: the
    distance to the far corner of the bounding box
    (fcpw_scene_loader.h:299-315)."""
    far = torch.maximum(torch.abs(x - soup.bmin), torch.abs(x - soup.bmax))
    return sqrt_rn(torch.sum(far * far, -1))


@_dispatch
def outside_bbox(soup: Seg2D, x):
    return torch.any((x < soup.bmin) | (x > soup.bmax), dim=-1)
