"""The 2D scenes from files against the JAX package, on the CPU
(tests/test_ingest.py and the scene cases of tests/test_multicyl.py).

geometry/obj_io.py, geometry/svg.py and utils/pfm.py are numpy copies and
read and write what the JAX package's do, exactly. scenes/custom.py's
polygon SDF and scene_from_obj at dim 2 build the same bbox, segment soup
and obstacle SDF; its closed obstacle loops walk on the soup, held to the
JAX package's gen walk with `walk_close` (a few walks a point may take
another path at a vertex, ROADMAP queue 3, item 13). A custom scene steps
under the fluid only when it takes a catalog scene's name (the hard
boundary conditions go by name, queue 3, item 14).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, spread, to_np, walk_close

import nmcfluid.geometry.obj_io as j_obj
import nmcfluid.geometry.svg as j_svg
import nmcfluid.scenes.custom as j_custom
import nmcfluid.sim.bem as jbem
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.wost import WalkSettings as JSettings, WostScene as JScene
from nmcfluid.wost.gen import estimate_solution_and_gradient_gen as j_gen

import nmcfluid_torch.geometry.obj_io as t_obj
import nmcfluid_torch.geometry.svg as t_svg
import nmcfluid_torch.scenes.custom as t_custom
import nmcfluid_torch.sim.bem as tbem
import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid_torch.sim import sampling as t_sampling
from nmcfluid_torch.wost.gen import estimate_solution_and_gradient_gen \
    as t_gen
from nmcfluid_torch.wost.solver import (WalkSettings as TSettings,
                                        WostScene as TScene)


def test_obj_roundtrip_and_fan_as_jax(tmp_path):
    v = [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]
    s = [[0, 1], [1, 2], [2, 0]]
    p = os.path.join(tmp_path, "t.obj")
    t_obj.write_obj_2d(p, v, s)
    for got, want in zip(t_obj.read_obj_2d(p), j_obj.read_obj_2d(p)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(t_obj.read_obj_2d(p)[0], v)
    q = os.path.join(tmp_path, "q.obj")
    with open(q, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    for got, want in zip(t_obj.read_obj_3d(q), j_obj.read_obj_3d(q)):
        np.testing.assert_array_equal(got, want)
    assert t_obj.read_obj_3d(q)[1].shape == (2, 3)


@pytest.mark.parametrize("d", ["M 0 0 L 1 0 L 1 1 Z", "M 0 0 C 0 1 1 1 1 0",
                               "m 1 1 h 2 v 1 q 1 1 2 0 z"])
def test_parse_path_as_jax(d):
    got, want = t_svg.parse_path(d, 8), j_svg.parse_path(d, 8)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_svg_to_parts_as_jax(tmp_path):
    svg = os.path.join(tmp_path, "a.svg")
    with open(svg, "w") as f:
        f.write('<svg xmlns="http://www.w3.org/2000/svg">'
                '<rect x="0" y="0" width="2" height="1"/>'
                '<line x1="0" y1="0" x2="1" y2="2"/>'
                '<path d="M 0 0 L 1 1"/></svg>')
    got, want = t_svg.svg_to_parts(svg), j_svg.svg_to_parts(svg)
    assert len(got) == len(want) == 3
    for (va, sa), (vb, sb) in zip(got, want):
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(sa, sb)
    assert len(got[0][1]) == 4          # the closed rect


def _two_squares():
    sq = lambda cx, cy, h: np.asarray(
        [(cx - h, cy - h), (cx + h, cy - h), (cx + h, cy + h),
         (cx - h, cy + h)])
    verts = np.concatenate([sq(-1.0, 0.0, 0.2), sq(0.5, 0.1, 0.3)])
    loop = lambda o: np.asarray([(o + i, o + (i + 1) % 4) for i in range(4)])
    return verts, np.concatenate([loop(0), loop(4)])


def test_polygon_sdf_matches_jax():
    """The crossing-number SDF over two disjoint loops (test_multicyl.py)
    and the unit square (test_ingest.py): the JAX package's values at
    rtol 1e-6 on points around both, the signs of the JAX tests."""
    verts, segs = _two_squares()
    x = np.random.default_rng(0).uniform(-1.5, 1.2, (256, 2)).astype(
        np.float32)
    x[:5] = [[-1.0, 0.0], [0.5, 0.1], [-0.3, 0.0], [2.0, 2.0], [-1.15, 0.15]]
    got = to_np(t_custom.polygon_sdf(verts, segs)(torch.from_numpy(x)))
    want = np.asarray(j_custom.polygon_sdf(verts, segs)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[[0, 1, 4]] < 0.0) and np.all(got[[2, 3]] > 0.0)
    v = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    s = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
    d = to_np(t_custom.polygon_sdf(v, s)(torch.tensor(
        [[0.5, 0.5], [2.0, 0.5], [0.5, -0.25]])))
    assert d[0] < 0 and abs(d[0] + 0.5) < 1e-5
    assert abs(d[1] - 1.0) < 1e-5 and abs(d[2] - 0.25) < 1e-5


def _two_cylinder_obj(path, name="karman"):
    """test_multicyl.py's user OBJ: an outer box and two 12-gon obstacle
    loops."""
    verts, lines = [], []

    def add_loop(pts):
        base = len(verts)
        verts.extend(pts)
        for i in range(len(pts)):
            lines.append((base + i + 1, base + (i + 1) % len(pts) + 1))
    add_loop([(-2.0, -1.0), (2.0, -1.0), (2.0, 1.0), (-2.0, 1.0)])
    t = 2 * np.pi * np.arange(12) / 12
    for cx, cy, r in [(-1.0, 0.0, 0.13), (0.0, 0.0, 0.13)]:
        # clockwise: the normals point out of the fluid, into the cylinder
        add_loop([(cx + r * np.cos(a), cy - r * np.sin(a)) for a in t])
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} 0\n")
        for a, b in lines:
            f.write(f"l {a} {b}\n")
    return t_custom.scene_from_obj(name, str(path)), \
        j_custom.scene_from_obj(name, str(path))


def test_scene_from_obj_matches_jax(tmp_path):
    """The bbox, the whole segment soup (silhouettes included), the
    obstacle SDF and the fluid mask of a two-loop OBJ; bem's closed loops
    as the JAX package takes them (its box only: closed_loops knows the
    box, circles and jpipe); dim=3, once refused, builds a triangle OBJ's
    soup as the JAX package does (tests/test_torch_soup3d.py steps one)."""
    ts, js = _two_cylinder_obj(tmp_path / "twocyl.obj", "user2cyl")
    assert ts.scene_size == js.scene_size == (-2.0, 2.0, -1.0, 1.0)
    for a, b in zip(ts.boundary, js.boundary):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    assert int(ts.boundary.a.shape[0]) >= 28
    x = np.asarray([[-1.0, 0.0], [0.0, 0.0], [-0.5, 0.0], [1.5, 0.5]],
                   np.float32)
    s = to_np(ts.obstacle_sdf(torch.from_numpy(x)))
    np.testing.assert_allclose(s, np.asarray(js.obstacle_sdf(jnp.asarray(x))),
                               rtol=1e-6)
    assert np.all(s[:2] < 0.0) and np.all(s[2:] > 0.0)
    np.testing.assert_array_equal(
        to_np(ts.fluid_mask(torch.from_numpy(x))),
        np.asarray(js.fluid_mask(jnp.asarray(x))))
    for a, b in zip(tbem.closed_loops(ts), jbem.closed_loops(js)):
        np.testing.assert_array_equal(a, b)
    tet = tmp_path / "tet.obj"
    tet.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    t3 = t_custom.scene_from_obj("x", str(tet), dim=3)
    j3 = j_custom.scene_from_obj("x", str(tet), dim=3)
    assert t3.dim == j3.dim == 3 and t3.scene_size == j3.scene_size
    for a, b in zip(t3.boundary, j3.boundary):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_walk_around_closed_loops_matches_jax(tmp_path):
    """The gen walk on the custom soup (the box and the two closed
    12-gons, sigma 350, a nearest-texel source from a random grid) at 32
    fluid points, some next to the loops' vertices, with 48 walks on the
    JAX-replay key: equal valid counts, p and grad p at tests/test_gen.py's
    tolerances on nine points in ten and the rest within the walk's own
    noise (walk_close)."""
    ts, js = _two_cylinder_obj(tmp_path / "twocyl.obj")
    pts, _ = t_sampling.fluid_points(JaxKey(jax.random.PRNGKey(9)), 32, ts)
    pts = to_np(pts)
    pts[:4] = [[-1.0 + 0.15, 0.0], [0.0, 0.14], [-0.86, 0.02],
               [0.1, -0.105]]
    grid = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    ss = ts.scene_size
    jsc = JScene(dim=2, neumann=js.boundary, absorption=350.0,
                 source_fn=lambda y, g: j_sampling.nearest_lookup(g, ss, y))
    tsc = TScene(dim=2, neumann=ts.boundary, absorption=350.0,
                 source_fn=lambda y, g: t_sampling.nearest_lookup(g, ss, y))

    def jax_walk(seed):
        return j_gen(jsc, JSettings(algo="gen"), jnp.asarray(pts),
                     jax.random.PRNGKey(seed), 48,
                     source_args=(jnp.asarray(grid),))
    p_j, g_j, n_j = jax_walk(3)
    p_j2, g_j2, _ = jax_walk(4)
    p_t, g_t, n_t = t_gen(tsc, TSettings(algo="gen"), torch.from_numpy(pts),
                          JaxKey(jax.random.PRNGKey(3)), 48,
                          source_args=(torch.from_numpy(grid),))
    np.testing.assert_array_equal(to_np(n_t), np.asarray(n_j))
    walk_close(to_np(p_t), p_j, spread(p_j, p_j2), 2e-4, 2e-5)
    walk_close(to_np(g_t), g_j, spread(g_j, g_j2), 2e-3, 2e-4)


def test_custom_scene_steps_only_under_a_catalog_name(tmp_path):
    """Named "karman" the custom scene takes karman's hard BCs and steps
    (finite params and pressure, its soup walked); under its own name
    the step raises NotImplementedError, as the JAX package's
    apply_boundary does (ROADMAP queue 3, item 14)."""
    kw = dict(max_n_iters=10, sample_resolution=8, wost_resolution=16,
              div_resolution=32, n_walks=16, fit_pool=4, device="cpu")
    ts, _ = _two_cylinder_obj(tmp_path / "k.obj")
    f = tfluid.NeuralFluid(ts, **kw)
    s = f.step(f.add_source(f.init_state(0)))
    _, p, gp, _ = f._last_projection
    for a in [s.P, p, gp] + [t for pair in s.params for t in pair]:
        assert bool(torch.isfinite(a).all())
    mine, _ = _two_cylinder_obj(tmp_path / "m.obj", "myscene")
    f = tfluid.NeuralFluid(mine, **kw)
    with pytest.raises(NotImplementedError, match="myscene"):
        f.add_source(f.init_state(0))
