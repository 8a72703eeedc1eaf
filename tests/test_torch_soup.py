"""The segment soup and its queries against the JAX package, on the CPU.

geometry/soup2d.py builds the same padded soup and silhouette table as
the JAX package (held exactly), and geometry/queries2d.py answers every
query as nmcfluid.geometry.queries2d does, on the J-pipe's soup (two open
chains: endpoints that are always silhouettes, the inner elbow's reflex
vertices) and on Taylor-Green's 40-segment box (no silhouettes), with
points and rays from numpy seeds. The port selects the winning segment by
argmin and a gather where the JAX package takes a one-hot sum; ties go to
the lowest index in both. The TG box soup agrees with the port's analytic
box, as tests/test_analytic_geom.py holds it in the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np

from nmcfluid.geometry import queries2d as j_q
from nmcfluid.geometry import soup2d as j_soup
from nmcfluid.scenes.specs import _jpipe_boundary as j_jpipe_boundary
from nmcfluid.scenes.specs import _tg_boundary_soup as j_tg_soup

from nmcfluid_torch.geometry import queries2d as t_q
from nmcfluid_torch.geometry import soup2d as t_soup
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.scenes.specs import TG_HI, TG_LO

SOUPS = ["jpipe", "tg_box"]


def _soups(name):
    """(JAX soup, port soup) of the jpipe scene or of TG's 40-segment box
    (the port builds the box soup from its own helpers)."""
    if name == "jpipe":
        return j_jpipe_boundary(None), t_get_scene("jpipe").boundary
    return j_tg_soup(None), t_soup.build_segments(
        [t_soup.box_loop(TG_LO, TG_HI, TG_LO, TG_HI, n_per_side=10)])


def _points(name, n, seed):
    """Points over the soup's box and a margin, with a share on and next
    to the vertices (the silhouettes and the chain ends) and on segment
    midpoints, where two segments tie."""
    rng = np.random.default_rng(seed)
    js = _soups(name)[0]
    lo, hi = np.asarray(js.bmin), np.asarray(js.bmax)
    m = 0.1 * (hi - lo)
    x = rng.uniform(lo - m, hi + m, (n, 2))
    verts = np.asarray(js.a)[np.asarray(js.a)[:, 0] < 1e5]
    k = n // 4
    x[:k] = verts[rng.integers(0, len(verts), k)] \
        + rng.normal(scale=1e-2, size=(k, 2))
    x[k:k + 16] = verts[:16]                       # exactly on vertices
    return x.astype(np.float32)


def test_build_segments_matches_jax():
    """The padded soup, normals, silhouette table and bbox of both shipped
    soups, and of a soup of two closed clockwise circles (every vertex
    reflex): equal to float32 rounding (atol 1e-7)."""
    cases = [(j_jpipe_boundary(None), t_get_scene("jpipe").boundary)]
    cases.append(_soups("tg_box"))
    parts = [(0.3, 0.4, 0.1), (0.7, 0.6, 0.2)]
    cases.append((
        j_soup.build_segments([j_soup.circle_loop_cw(c[:2], c[2], n=12)
                               for c in parts]),
        t_soup.build_segments([t_soup.circle_loop_cw(c[:2], c[2], n=12)
                               for c in parts])))
    for js, ts in cases:
        for name in js._fields:
            a, b = to_np(getattr(ts, name)), np.asarray(getattr(js, name))
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=name)
    jp = cases[0][0]
    # the J-pipe: 44 segments padded to 48, four chain ends always
    # silhouettes, the inner elbow's 21 vertices reflex
    assert jp.a.shape == (48, 2)
    assert int(np.sum(np.asarray(jp.s_always))) == 4
    assert int(np.sum(np.asarray(jp.sv)[:, 0] < 1e5)) == 4 + 21


@pytest.mark.parametrize("name", SOUPS)
@pytest.mark.parametrize("query", ["closest_point", "inside",
                                   "star_radius", "dist_to_far_bbox_corner",
                                   "outside_bbox"])
def test_point_queries_match_jax(name, query):
    """closest_point (distance, signed distance, point, normal), inside,
    star_radius (with min and max radii), the far-corner distance and the
    bbox test: rtol 1e-6 / atol 1e-6, flags equal. Points exactly on the
    vertices tie two segments: the winner's point is the vertex either
    way, its normal the lower index's in both packages."""
    js, ts = _soups(name)
    x = _points(name, 3000, 1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if query == "star_radius":
        mx = np.random.default_rng(2).uniform(0, 3, x.shape[0]).astype(
            np.float32)
        want = [j_q.star_radius(js, jx, 1e-3, jnp.asarray(mx))]
        got = [t_q.star_radius(ts, tx, 1e-3, torch.from_numpy(mx))]
    else:
        want = getattr(j_q, query)(js, jx)
        got = getattr(t_q, query)(ts, tx)
        if not isinstance(want, tuple):
            want, got = [want], [got]
    for a, b in zip(got, want):
        if np.asarray(b).dtype == bool:
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
        else:
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def _rays(name, n, seed):
    rng = np.random.default_rng(seed)
    x = _points(name, n, seed)
    phi = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(phi), np.sin(phi)], -1).astype(np.float32)
    tmax = rng.uniform(0.0, 3.0 if name == "jpipe" else 8.0, n)
    return x, d, tmax.astype(np.float32)


def _first_hit64(soup, o, d):
    """The distance along each ray to its first segment, in float64
    (inf if none)."""
    a = np.asarray(soup.a, np.float64)[None]
    ab = np.asarray(soup.b, np.float64)[None] - a
    ao = a - o[:, None]
    cross = d[:, None, 0] * ab[..., 1] - d[:, None, 1] * ab[..., 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ao[..., 0] * ab[..., 1] - ao[..., 1] * ab[..., 0]) / cross
        s = (ao[..., 0] * d[:, None, 1] - ao[..., 1] * d[:, None, 0]) / cross
    t = np.where((np.abs(cross) > 1e-12) & (s >= 0) & (s <= 1) & (t > 0),
                 t, np.inf)
    return t.min(1)


@pytest.mark.parametrize("name", SOUPS)
def test_ray_queries_match_jax(name):
    """ray_intersect: the same hit flags and, on them, t, point and normal
    at rtol 1e-6 / atol 1e-6 (rays escaping through the J-pipe's open
    ends hit nothing); has_line_of_sight equal. Rays within 1e-4 of a
    vertex or ending within 1e-4 of their hit are left out: a last-ulp
    difference may flip the flag there."""
    js, ts = _soups(name)
    o, d, tmax = _rays(name, 4000, 3)
    jh = j_q.ray_intersect(js, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tmax))
    th = t_q.ray_intersect(ts, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tmax))
    # clear rays, in float64: far from every vertex along the ray, and the
    # hit not at t_max
    verts = np.asarray(js.a, np.float64)[np.asarray(js.a)[:, 0] < 1e5]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    rel = verts[None] - o64[:, None]
    along = np.clip(np.sum(rel * d64[:, None], -1), 0, tmax[:, None])
    miss = np.linalg.norm(rel - along[..., None] * d64[:, None], axis=-1)
    ok = miss.min(1) > 1e-4
    ok &= np.abs(_first_hit64(js, o64, d64) - tmax) > 1e-4
    hit_j = np.asarray(jh[0])
    np.testing.assert_array_equal(to_np(th[0])[ok], hit_j[ok])
    assert (ok & hit_j).sum() > 500 and (ok & ~hit_j).sum() > 500
    for a, b in zip(th[1:], jh[1:]):
        np.testing.assert_allclose(to_np(a)[ok & hit_j],
                                   np.asarray(b)[ok & hit_j], rtol=1e-6,
                                   atol=1e-6)
    y = o + tmax[:, None] * d
    np.testing.assert_array_equal(
        to_np(t_q.has_line_of_sight(ts, torch.from_numpy(o),
                                    torch.from_numpy(y)))[ok],
        np.asarray(j_q.has_line_of_sight(js, jnp.asarray(o),
                                         jnp.asarray(y)))[ok])


def test_ties_go_to_the_lowest_index():
    """A point equidistant from two segments and a ray through a shared
    vertex: both packages pick the lower segment index (jnp.argmin's
    rule), so the normals agree exactly."""
    verts = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    parts = [t_soup.polyline_chain(verts)]
    ts = t_soup.build_segments(parts)
    js = j_soup.build_segments([j_soup.polyline_chain(verts)])
    x = np.asarray([[0.5, 0.5], [1.5, -0.5], [0.75, 0.25]], np.float32)
    _, _, _, n_t = t_q.closest_point(ts, torch.from_numpy(x))
    _, _, _, n_j = j_q.closest_point(js, jnp.asarray(x))
    np.testing.assert_array_equal(to_np(n_t), np.asarray(n_j))
    np.testing.assert_array_equal(to_np(n_t)[1], [0.0, -1.0])
    o = np.asarray([[0.5, -0.5]], np.float32)
    d = np.asarray([[np.sqrt(0.5), np.sqrt(0.5)]], np.float32)
    h_t = t_q.ray_intersect(ts, torch.from_numpy(o), torch.from_numpy(d),
                            torch.tensor([5.0]))
    h_j = j_q.ray_intersect(js, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray([5.0]))
    for a, b in zip(h_t, h_j):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_tg_box_soup_matches_port_analytic_box():
    """The 40-segment TG box soup against the port's analytic box, as
    tests/test_analytic_geom.py holds the JAX package's: distance at atol
    2e-5, inside equal, rays' hit flags equal, t at atol 1e-3, normals at
    atol 1e-4."""
    ana = t_get_scene("taylorgreen").boundary
    soup = _soups("tg_box")[1]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.1, 6.2, (256, 2)).astype(np.float32))
    np.testing.assert_allclose(to_np(t_q.distance(ana, x)),
                               to_np(t_q.distance(soup, x)), atol=2e-5)
    np.testing.assert_array_equal(to_np(t_q.inside(ana, x)),
                                  to_np(t_q.inside(soup, x)))
    v = rng.normal(size=(256, 2))
    d = torch.from_numpy((v / np.linalg.norm(v, axis=-1,
                                             keepdims=True)).astype(
        np.float32))
    tmax = torch.full((256,), 20.0)
    ha, ta, _, na = t_q.ray_intersect(ana, x, d, tmax)
    hs, ts_, _, ns = t_q.ray_intersect(soup, x, d, tmax)
    np.testing.assert_array_equal(to_np(ha), to_np(hs))
    np.testing.assert_allclose(to_np(ta), to_np(ts_), atol=1e-3)
    np.testing.assert_allclose(to_np(na), to_np(ns), atol=1e-4)


def test_analytic_boundaries_dispatch():
    """An Analytic2D boundary goes to analytic2d's own query, so the TG
    and karman walks are unchanged."""
    from nmcfluid_torch.geometry import analytic2d
    b = t_get_scene("karman").boundary
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        -1.0, 1.5, (64, 2)).astype(np.float32))
    for name in ("distance", "signed_distance", "outside_bbox",
                 "dist_to_far_bbox_corner"):
        assert torch.equal(getattr(t_q, name)(b, x),
                           getattr(analytic2d, name)(b, x))
    r = torch.full((64,), 2.0)
    assert torch.equal(t_q.star_radius(b, x, 1e-3, r),
                       analytic2d.star_radius(b, x, 1e-3, r))
