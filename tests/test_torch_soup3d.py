"""3D triangle soups and their queries against the JAX package, on the CPU.

`build_triangles` must give the JAX package's tables entry for entry
(faces, normals, the silhouette-edge table with its open-boundary flags,
the padding and the bbox), and every query of queries3d must give the
JAX package's numbers on the same points: tests/test_geometry.py:91-138's
cube and reflex soup, an open mesh whose boundary edges are always
silhouettes, and random points and rays around them. Both packages run
the same float32 formulas, except that XLA may contract a product and a
sum into one FMA: positions and distances are held at rtol 1e-6 / atol
1e-6 (tests/test_geometry.py's atol), flags and codes exactly. A Box3D
reaches analytic3d through the dispatch with the same bits, so the
shipped 3D scenes walk and mask as before. Custom 3D scenes
(scene_from_obj(dim=3)) are built as JAX builds them and step under a
catalog name.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np

from nmcfluid.geometry import (box_tris as j_box_tris, build_triangles as
                               j_build, queries3d as jq)
from nmcfluid.geometry.obj_io import write_obj_3d
from nmcfluid.scenes import specs as j_specs
from nmcfluid.scenes.custom import scene_from_obj as j_scene_from_obj

from nmcfluid_torch.geometry import (analytic3d as t_box3d, box_tris,
                                     build_triangles, queries3d as tq)
from nmcfluid_torch.scenes import specs as t_specs
from nmcfluid_torch.scenes.custom import scene_from_obj
from nmcfluid_torch.sim.fluid import NeuralFluid

TOL = dict(rtol=1e-6, atol=1e-6)

# tests/test_geometry.py:119-138: the two walls of an L-shaped prism's
# reflex corner
L_VERTS = np.array([
    [0, 0, 0], [2, 0, 0], [2, 1, 0], [1, 1, 0], [1, 2, 0], [0, 2, 0],
    [0, 0, 1], [2, 0, 1], [2, 1, 1], [1, 1, 1], [1, 2, 1], [0, 2, 1],
], dtype=float)
L_FACES = np.asarray([[3, 4, 10], [3, 10, 9], [3, 9, 8], [3, 8, 2]])


def _soups():
    """name -> (verts, faces): the unit cube, the reflex corner, an open
    box (the cube less its top) and a cube with a degenerate face."""
    v, f = box_tris((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    degen = np.concatenate([f, [[0, 0, 1]]])
    return {"cube": (v, f), "reflex": (L_VERTS, L_FACES),
            "open": (v, np.concatenate([f[:2], f[4:]])),
            "degenerate": (v, degen)}


SOUPS = _soups()


@pytest.mark.parametrize("name", sorted(SOUPS))
def test_build_triangles_tables_match_jax(name):
    """Every table of the Tri3D, entry for entry (one float64 host build
    rounded to float32 in both packages)."""
    v, f = SOUPS[name]
    t, j = build_triangles(v, f), j_build(v, f)
    assert t._fields == j._fields
    for field, a, b in zip(t._fields, t, j):
        np.testing.assert_array_equal(to_np(a), np.asarray(b),
                                      err_msg=field)
    assert t.va.shape[0] % 8 == 0 and t.ea.shape[0] % 8 == 0
    if name == "open":
        assert int(to_np(t.e_always).sum()) == 4    # the top's rim


def test_tri_closest_point_cube():
    """tests/test_geometry.py:93-110 on the port: distances and signs,
    the empty silhouette table of a convex closed mesh, and the star
    radius it gives (the cap)."""
    v, f = box_tris((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    soup = build_triangles(v, f)
    x = torch.tensor([[0.5, 0.5, 0.5], [0.5, 0.5, 0.9], [2.0, 0.5, 0.5]])
    dist, sdist, pt, nrm = tq.closest_point(soup, x)
    np.testing.assert_allclose(to_np(dist), [0.5, 0.1, 1.0], atol=1e-6)
    assert to_np(sdist)[0] < 0 and to_np(sdist)[1] < 0
    assert to_np(sdist)[2] > 0
    assert not np.any(to_np(soup.e_always))
    assert np.all(to_np(soup.ea) >= 1e5)
    r = tq.star_radius(soup, x, 1e-3, torch.full((3,), 4.0))
    np.testing.assert_allclose(to_np(r), 4.0)


def test_tri_ray_cube():
    """tests/test_geometry.py:113-122: the exit through the top face."""
    v, f = box_tris((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    soup = build_triangles(v, f)
    hit, t, pt, nrm = tq.ray_intersect(
        soup, torch.tensor([[0.5, 0.5, 0.5]]), torch.tensor([[0.0, 0.0,
                                                              1.0]]),
        torch.tensor([9.0]))
    assert bool(hit[0])
    np.testing.assert_allclose(to_np(t), [0.5], atol=1e-6)
    np.testing.assert_allclose(to_np(nrm), [[0, 0, 1]], atol=1e-6)


def test_reflex_edges_detected():
    """tests/test_geometry.py:119-138: the shared vertical edge at the
    reflex corner is a silhouette candidate."""
    soup = build_triangles(L_VERTS, L_FACES)
    ea = to_np(soup.ea)
    real = ea[ea[:, 0] < 1e5]
    assert len(real) >= 1
    assert np.any(np.all(np.abs(real[:, :2] - 1.0) < 1e-6, axis=1))


def _probe(name, n=256):
    """Points in and around the soup's bbox (some on its faces), unit
    directions, caps and second points, from one numpy seed a soup."""
    v, _ = SOUPS[name]
    lo, hi = v.min(0) - 0.5, v.max(0) + 0.5
    rng = np.random.default_rng(len(name))
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    x[:16, 2] = 0.0                                   # on the z = 0 plane
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cap = rng.uniform(0.05, 3.0, n).astype(np.float32)
    y = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return x, d, cap, y


@pytest.mark.parametrize("name", sorted(SOUPS))
def test_queries_match_jax(name):
    """closest_point, signed_distance, inside, ray_intersect,
    has_line_of_sight, star_radius, dist_to_far_bbox_corner and
    outside_bbox on the same points as the JAX package's."""
    v, f = SOUPS[name]
    t, j = build_triangles(v, f), j_build(v, f)
    x, d, cap, y = _probe(name)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for a, b, what in zip(tq.closest_point(t, tx), jq.closest_point(j, jx),
                          ("dist", "signed", "point", "normal")):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL,
                                   err_msg=what)
    np.testing.assert_array_equal(to_np(tq.inside(t, tx)),
                                  np.asarray(jq.inside(j, jx)))
    got = tq.ray_intersect(t, tx, torch.from_numpy(d), torch.from_numpy(cap))
    want = jq.ray_intersect(j, jx, jnp.asarray(d), jnp.asarray(cap))
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(want[0]))
    assert 0 < to_np(got[0]).sum() < len(x)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL)
    np.testing.assert_array_equal(
        to_np(tq.has_line_of_sight(t, tx, torch.from_numpy(y))),
        np.asarray(jq.has_line_of_sight(j, jx, jnp.asarray(y))))
    np.testing.assert_allclose(
        to_np(tq.star_radius(t, tx, 1e-3, torch.from_numpy(cap))),
        np.asarray(jq.star_radius(j, jx, 1e-3, jnp.asarray(cap))), **TOL)
    for fn in ("dist_to_far_bbox_corner", "outside_bbox"):
        np.testing.assert_allclose(to_np(getattr(tq, fn)(t, tx)),
                                   np.asarray(getattr(jq, fn)(j, jx)),
                                   **TOL, err_msg=fn)


def test_silhouettes_shorten_star_radius():
    """Where a reflex edge or an open rim is in view the star radius
    stops at it; the always-silhouette rim of the open box caps points
    near the missing top."""
    for name in ("reflex", "open"):
        v, f = SOUPS[name]
        x, _, cap, _ = _probe(name)
        r = to_np(tq.star_radius(build_triangles(v, f), torch.from_numpy(x),
                                 1e-3, torch.from_numpy(cap + 2.0)))
        assert np.mean(r < cap + 2.0) > 0.2, name


def test_box3d_dispatch_keeps_the_closed_forms():
    """A Box3D boundary goes to analytic3d with the same bits: the shipped
    3D scenes' walks and pressure masks do not change."""
    box = t_specs._cube_boundary(None)
    x, d, cap, _ = (torch.from_numpy(a) for a in _probe("cube"))
    x = x * 2.0 - 1.0
    for fn, args in (("closest_point", ()), ("ray_intersect", (d, cap)),
                     ("star_radius", (1e-3, cap)),
                     ("dist_to_far_bbox_corner", ()), ("outside_bbox", ()),
                     ("signed_distance", ())):
        got, want = (getattr(m, fn)(box, x, *args) for m in (tq, t_box3d))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), fn


def test_cube_boundary_soup_matches_jax():
    """specs._cube_boundary_soup: the reference's 12-triangle cube.obj."""
    t, j = t_specs._cube_boundary_soup(None), j_specs._cube_boundary_soup(
        None)
    for field, a, b in zip(t._fields, t, j):
        np.testing.assert_array_equal(to_np(a), np.asarray(b),
                                      err_msg=field)


@pytest.mark.parametrize("base", ["smoke", "karman"])
def test_scene_from_obj_3d_matches_jax(tmp_path, base):
    """scene_from_obj(dim=3) on a fan-triangulated OBJ (tests/
    test_ingest.py:22-28's quad, here a box of quads): the same soup,
    scene size, hyperparameters and no obstacle SDF as the JAX package's,
    also from a 2D base (whose settings it keeps, as JAX does)."""
    v, _ = box_tris((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    quads = [[0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4], [3, 7, 6, 2],
             [0, 4, 7, 3], [1, 2, 6, 5]]
    p = tmp_path / "box.obj"
    with open(p, "w") as fh:
        fh.write("".join(f"v {a} {b} {c}\n" for a, b, c in v))
        fh.write("".join("f " + " ".join(str(i + 1) for i in q) + "\n"
                         for q in quads))
    ts = scene_from_obj("custom3d", str(p), dim=3, base=base)
    js = j_scene_from_obj("custom3d", str(p), dim=3, base=base)
    assert ts.boundary.va.shape[0] == 16                 # 12 + 4 padded
    for field, a, b in zip(ts.boundary._fields, ts.boundary, js.boundary):
        np.testing.assert_array_equal(to_np(a), np.asarray(b),
                                      err_msg=field)
    assert ts.dim == js.dim == 3
    assert ts.scene_size == js.scene_size == (-1.0, 1.0) * 3
    for f in ("num_hidden_layers", "hidden_features", "n_walks", "lr",
              "wost_resolution", "absorption", "reset_wts"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.obstacle_sdf is None and js.obstacle_sdf is None
    x = torch.tensor([[0.0, 0.0, 0.0], [0.5, -0.2, 0.99]])
    np.testing.assert_allclose(
        to_np(tq.signed_distance(ts.boundary, x)),
        np.asarray(jq.signed_distance(js.boundary, jnp.asarray(to_np(x)))),
        **TOL)


def test_custom_3d_scene_steps(tmp_path):
    """A triangle OBJ scene under a catalog name (smoke, whose hard BCs it
    takes) steps on the CPU: add_source and one step, the walk on the
    soup (fluid.q is queries3d), a finite P and velocity."""
    v, f = j_box_tris((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    p = tmp_path / "cube.obj"
    write_obj_3d(str(p), v, f)
    scene = scene_from_obj("smoke", str(p), dim=3, base="smoke")
    scene = dataclasses.replace(scene, _source_builder=t_specs.get_scene(
        "smoke")._source_builder)
    fl = NeuralFluid(scene, max_n_iters=10, sample_resolution=8,
                     wost_resolution=8, div_resolution=8, n_walks=8,
                     fit_pool=4, device="cpu")
    assert fl.q is tq and type(fl.boundary).__name__ == "Tri3D"
    st = fl.step(fl.add_source(fl.init_state(0)))
    assert st.timestep == 1 and np.isfinite(float(st.P))
    u = fl.sample_velocity_grid(st, 6, with_boundary=False)
    assert u.shape == (6, 6, 6, 3) and bool(torch.isfinite(u).all())
