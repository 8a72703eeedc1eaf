"""Brute-force geometric queries over 3D triangle soups (port of
nmcfluid/geometry/queries3d.py).

Each query broadcasts a batch of points x (..., 3) against the padded
triangles (P, 3) of a Tri3D and reduces over them (the role of FCPW's
GeometricQueries<3>): the closest point by the region-classified
point-triangle projection, rays by Moller-Trumbore, the star radius from
the silhouette edges. Where the JAX package selects the winning triangle
by a one-hot weighted sum (a TPU workaround for per-lane gathers), this
port takes argmin and a gather: the same winner, ties to the lowest
index, as jnp.argmin. Box3D boundaries (the shipped 3D scenes' cube) go
to their closed forms in analytic3d, so their walks stay as they are.
"""
import torch

from . import analytic3d
from .analytic3d import Box3D
from .sdf import sqrt_rn
from .soup3d import FAR, Tri3D  # noqa: F401  (Tri3D re-exported)

OFFSET_EPS = 3e-5  # stand-in for fcpw's ~256-ULP offsetPointAlongDirection


def _dispatch(fn):
    """Route Box3D boundaries to analytic3d's query of the same name;
    triangle soups take the brute-force path below."""
    afn = getattr(analytic3d, fn.__name__, None)

    def wrapper(soup, *a, **kw):
        if isinstance(soup, Box3D):
            return afn(soup, *a, **kw)
        return fn(soup, *a, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _dot(a, b):
    return torch.sum(a * b, -1)


def _cross(a, b):
    """a x b over the last axis, broadcasting (jnp.cross's formula)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _closest_on_tri(p, a, b, c):
    """Closest point on triangle abc to p (broadcast-compatible)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = torch.clamp(va + vb + vc, min=1e-30)
    v = vb / denom
    w = vc / denom
    pt_face = a + v[..., None] * ab + w[..., None] * ac

    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0.0, 1.0)
    pt_ab = a + t_ab[..., None] * ab
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0.0, 1.0)
    pt_ac = a + t_ac[..., None] * ac
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6),
                                               min=1e-30), 0.0, 1.0)
    pt_bc = b + t_bc[..., None] * (c - b)

    pt = pt_face
    pt = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], pt_ab,
                     pt)
    pt = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], pt_ac,
                     pt)
    pt = torch.where(((va <= 0) & ((d4 - d3) >= 0)
                      & ((d5 - d6) >= 0))[..., None], pt_bc, pt)
    pt = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, pt)
    pt = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, pt)
    pt = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, pt)
    return pt


def _take(table, idx):
    """table[idx] for a (P, C) table and (...,) indices -> (..., C)."""
    return table[idx.reshape(-1)].reshape(idx.shape + table.shape[1:])


@_dispatch
def closest_point(soup: Tri3D, x):
    """(dist, signed_dist, point, normal) of the closest boundary point;
    signed_dist is negative on the fluid side (the normals point out of
    it). Box3D boundaries return (dist, signed_dist) only."""
    p = _closest_on_tri(x[..., None, :], soup.va, soup.vb, soup.vc)
    d2 = torch.sum((x[..., None, :] - p) ** 2, -1)          # (..., P)
    i = torch.argmin(d2, dim=-1)
    dist = sqrt_rn(torch.gather(d2, -1, i[..., None])[..., 0])
    pt = torch.gather(p, -2, i[..., None, None].expand(
        i.shape + (1, 3)))[..., 0, :]
    nrm = _take(soup.n, i)
    sign = torch.where(_dot(x - pt, nrm) < 0.0, -1.0, 1.0)
    return dist, sign * dist, pt, nrm


def distance(soup, x):
    return closest_point(soup, x)[0]


def signed_distance(soup, x):
    return closest_point(soup, x)[1]


def inside(soup, x):
    return signed_distance(soup, x) < 0.0


@_dispatch
def ray_intersect(soup: Tri3D, o, d, t_max):
    """First hit of the rays o + t d, 0 < t <= t_max, against every
    triangle (Moller-Trumbore): (hit, t, point, normal) with the face's
    stored normal."""
    e1 = soup.vb - soup.va                                   # (P, 3)
    e2 = soup.vc - soup.va
    pvec = _cross(d[..., None, :], e2)                       # (..., P, 3)
    det = _dot(e1, pvec)
    small = torch.abs(det) < 1e-12
    safe = torch.where(small, 1.0, det)
    tvec = o[..., None, :] - soup.va
    u = _dot(tvec, pvec) / safe
    qvec = _cross(tvec, e1)
    v = _dot(d[..., None, :], qvec) / safe
    t = _dot(e2, qvec) / safe
    ok = (~small & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & (t <= t_max[..., None]))
    t = torch.where(ok, t, float("inf"))
    i = torch.argmin(t, dim=-1)
    t_hit = torch.gather(t, -1, i[..., None])[..., 0]
    nrm = _take(soup.n, i)
    hit = torch.isfinite(t_hit)
    t_hit = torch.where(hit, t_hit, t_max)
    return hit, t_hit, o + t_hit[..., None] * d, nrm


@_dispatch
def has_line_of_sight(soup: Tri3D, x, y):
    """True where the open segment x -> y crosses no triangle."""
    d = y - x
    ln = sqrt_rn(torch.sum(d * d, -1))
    dn = d / torch.clamp(ln, min=1e-20)[..., None]
    hit, _, _, _ = ray_intersect(soup, x, dn, ln * (1.0 - 1e-5))
    return ~hit


@_dispatch
def star_radius(soup: Tri3D, x, min_radius, max_radius):
    """Distance to the closest silhouette edge point within max_radius,
    else max_radius, floored at min_radius: an edge is a silhouette from
    x when its two faces face opposite sides of x, and always for an
    open-boundary edge."""
    if soup.ea.shape[0] == 0:
        return torch.clamp(max_radius, min=min_radius)
    ea, eb = soup.ea, soup.eb
    e = eb - ea
    denom = torch.clamp(_dot(e, e), min=1e-20)
    xa = x[..., None, :] - ea
    t = torch.clamp(_dot(xa, e) / denom, 0.0, 1.0)
    p = ea + t[..., None] * e
    xp = x[..., None, :] - p                                 # (..., E, 3)
    d1 = _dot(xp, soup.en1)
    d2 = _dot(xp, soup.en2)
    is_sil = (d1 * d2 <= 0.0) | soup.e_always
    dist = sqrt_rn(_dot(xp, xp))
    dist = torch.where(is_sil, dist, FAR)
    closest = torch.amin(dist, dim=-1)
    r = torch.where(closest < max_radius, closest, max_radius)
    return torch.clamp(r, min=min_radius)


@_dispatch
def dist_to_far_bbox_corner(soup: Tri3D, x):
    """The distance to the far corner of the bounding box: zombie's
    distance to Dirichlet without a Dirichlet boundary."""
    far = torch.maximum(torch.abs(x - soup.bmin), torch.abs(x - soup.bmax))
    return sqrt_rn(torch.sum(far * far, -1))


@_dispatch
def outside_bbox(soup: Tri3D, x):
    return torch.any((x < soup.bmin) | (x > soup.bmax), dim=-1)
