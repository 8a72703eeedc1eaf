"""Boundary value caching against the JAX package, on the CPU.

wost/bvc.py (tests/test_bvc.py): the boundary sampler's categorical draw
replayed exactly through the JAX-replay key, the cache walk, the splat
(value and gradient, on-boundary points, the 3D regularizers);
sim/bem.py's BvcProjector (tests/test_bvcproj.py) on one divergence grid
and key; `_pressure_solve_bvc` and one chained Taylor-Green step under
projection="bvc"; and the multi-loop case of tests/test_multicyl.py on
karman2cyl with bvc as a third solver beside bem and the walk. The
splats sum over the cache and the source samples in another order than
XLA's, so values are held at 1e-5 of their magnitude (as
tests/test_torch_bem.py holds the BEM splat); the walks at
tests/test_gen.py's tolerances.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (JaxKey, _record, mc_below, mc_close, params_np,
                           to_np)

import nmcfluid.sim.bem as jbem
import nmcfluid.sim.fluid as jfluid
import nmcfluid.wost.bvc as jbvc
import nmcfluid_torch.sim.bem as tbem
import nmcfluid_torch.sim.fluid as tfluid
import nmcfluid_torch.wost.bvc as tbvc
from nmcfluid.geometry import soup2d as j_soup
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.wost import solver as j_solver
from nmcfluid_torch.geometry import soup2d as t_soup
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import sampling as t_sampling
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost import solver as t_solver

L = 2.0
SIGMA = 30.0
KX = math.pi / L
TOL = 1e-5


def close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def _box(jax_side):
    """tests/test_bvc.py's setup: the 16-segment box soup, sigma 30,
    p* = cos(KX x) cos(KX y)."""
    if jax_side:
        soup = j_soup.build_segments([j_soup.box_loop(0.0, L, 0.0, L, 4)])
        src = lambda x: (SIGMA + 2 * KX ** 2) * jnp.cos(KX * x[..., 0]) \
            * jnp.cos(KX * x[..., 1])
        return soup, j_solver.WostScene(dim=2, neumann=soup, source_fn=src,
                                        absorption=SIGMA)
    soup = t_soup.build_segments([t_soup.box_loop(0.0, L, 0.0, L, 4)])
    src = lambda x: (SIGMA + 2 * KX ** 2) * torch.cos(KX * x[..., 0]) \
        * torch.cos(KX * x[..., 1])
    return soup, t_solver.WostScene(dim=2, neumann=soup, source_fn=src,
                                    absorption=SIGMA)


def _p_star(x):
    return np.cos(KX * x[..., 0]) * np.cos(KX * x[..., 1])


@pytest.fixture(scope="module")
def caches():
    """build_cache in both packages: 128 samples, 256 walks, key 1."""
    key = jax.random.PRNGKey(1)
    (js, jsc), (ts, tsc) = _box(True), _box(False)
    jc = jbvc.build_cache(jsc, j_solver.WalkSettings(walk_step_cap=96), js,
                          128, key, n_walks=256)
    tc = tbvc.build_cache(tsc, t_solver.WalkSettings(walk_step_cap=96), ts,
                          128, JaxKey(key), n_walks=256)
    return jsc, jc, tsc, tc


def test_boundary_sampling_replays_jax():
    """sample_boundary_uniform on the same key: the same segments (the
    categorical draw through the replay key), points, normals and pdf;
    every sample on the box's edges with pdf 1 / perimeter."""
    (js, _), (ts, _) = _box(True), _box(False)
    key = jax.random.PRNGKey(0)
    pj, nj, dj = jbvc.sample_boundary_uniform(js, 512, key)
    pt, nt, dt = tbvc.sample_boundary_uniform(ts, 512, JaxKey(key))
    np.testing.assert_array_equal(to_np(nt), np.asarray(nj))
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=1e-6)
    p = to_np(pt)
    on_edge = (np.abs(p[:, 0]) < 1e-6) | (np.abs(p[:, 0] - L) < 1e-6) \
        | (np.abs(p[:, 1]) < 1e-6) | (np.abs(p[:, 1] - L) < 1e-6)
    assert on_edge.all()
    np.testing.assert_allclose(to_np(dt), 1.0 / (4 * L), rtol=1e-5)


def test_port_key_categorical_is_the_softmax():
    """The port's own key draws its categorical by the Gumbel-max rule:
    40,000 draws from logits log(w) land on each index in proportion to
    w, within 4 standard errors."""
    w = torch.tensor([0.1, 0.4, 0.2, 0.3])
    idx = Key(3).categorical(torch.log(w), (40000,))
    freq = torch.bincount(idx, minlength=4).double() / 40000
    se = torch.sqrt(w.double() * (1 - w.double()) / 40000)
    mc_below(((freq - w.double()).abs() / se).max(), 4, "frequency / se")


def test_build_cache_matches_jax(caches):
    """The cache walk at the same samples on the same key: the walk's p
    tolerance, a zero normal derivative (pure Neumann, zero data)."""
    _, jc, _, tc = caches
    np.testing.assert_allclose(to_np(tc.pts), np.asarray(jc.pts), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(to_np(tc.solution), np.asarray(jc.solution),
                               rtol=2e-4, atol=2e-5)
    assert np.allclose(to_np(tc.normal_derivative), 0.0)


@pytest.mark.parametrize("case", ["value", "gradient", "on_boundary"])
def test_evaluate_matches_jax(caches, case):
    """The splat of the same cache with the same source samples: value,
    gradient, and on-boundary points (alpha 2, zero gradient)."""
    jsc, jc, tsc, tc = caches
    src = np.random.RandomState(2).uniform(0, L, (2048, 2)).astype(
        np.float32)
    pdf = np.full(2048, 1.0 / (L * L), np.float32)
    ev = np.asarray([[1.0, 1.0], [0.6, 0.8], [1.4, 0.5], [0.0, 1.0]],
                    np.float32)
    kw = dict(radius_clamp=1e-3, kernel_regularization=0.05,
              with_gradient=case != "value")
    if case == "on_boundary":
        ob = np.asarray([False, False, False, True])
        kw_j = dict(kw, on_boundary=jnp.asarray(ob))
        kw_t = dict(kw, on_boundary=torch.from_numpy(ob))
    else:
        kw_j = kw_t = kw
    oj = jbvc.evaluate(jsc, jc, jnp.asarray(ev), jnp.asarray(src),
                       jnp.asarray(pdf), 2048, **kw_j)
    ot = tbvc.evaluate(tsc, tc, torch.from_numpy(ev), torch.from_numpy(src),
                       torch.from_numpy(pdf), 2048, **kw_t)
    for a, b in zip(ot if kw["with_gradient"] else [ot],
                    oj if kw["with_gradient"] else [oj]):
        close(a, b)
    if case == "on_boundary":
        assert np.allclose(to_np(ot[1])[3], 0.0)


@pytest.mark.parametrize("lam", [30.0, 0.0])
def test_regularizers_and_3d_splat_match_jax(lam):
    """The 3D value kernels with the erf regularizers, through evaluate on
    a hand-made cache (no walk)."""
    rs = np.random.RandomState(4)
    B = 64
    cp = rs.randn(B, 3).astype(np.float32)
    cn = rs.randn(B, 3)
    cn = (cn / np.linalg.norm(cn, axis=1, keepdims=True)).astype(np.float32)
    sol = rs.randn(B).astype(np.float32)
    dn = rs.randn(B).astype(np.float32)
    pdf = np.full(B, 0.3, np.float32)
    ev = (0.5 * rs.randn(16, 3)).astype(np.float32)
    src = lambda x: x[..., 0]
    out = []
    for mod, S, arr in ((jbvc, j_solver, jnp.asarray),
                        (tbvc, t_solver, torch.from_numpy)):
        sc = S.WostScene(dim=3, neumann=None, source_fn=src, absorption=lam)
        cache = mod.BoundaryCache(arr(cp), arr(cn), arr(pdf), arr(sol),
                                  arr(dn))
        out.append(mod.evaluate(sc, cache, arr(ev), arr(cp), arr(pdf), B,
                                radius_clamp=1e-3, kernel_regularization=0.3,
                                with_gradient=True))
    (jt, gj), (tt, gt) = out
    close(tt, jt)
    close(gt, gj)


def test_bvc_manufactured_solution():
    """tests/test_bvc.py on the port alone with its own key: the cache of
    512 (value) and 1024 (gradient) samples at 800 walks, the MC source
    sum, at the JAX tests' atol (0.08 value, 0.2 gradient, 0.15 on the
    boundary), and nonzero Neumann data carried by the G term."""
    soup, scene = _box(False)
    s = t_solver.WalkSettings(walk_step_cap=96)
    cache = tbvc.build_cache(scene, s, soup, 512, Key(1), n_walks=800)
    g = torch.Generator().manual_seed(2)
    src = torch.rand((8192, 2), generator=g) * L
    pdf = torch.full((8192,), 1.0 / (L * L))
    ev = torch.tensor([[1.0, 1.0], [0.6, 0.8], [1.4, 0.5], [0.5, 1.5]])
    u = tbvc.evaluate(scene, cache, ev, src, pdf, 8192, radius_clamp=1e-3,
                      kernel_regularization=0.05)
    mc_close(u, _p_star(to_np(ev)), 0.08, "p")
    cache = tbvc.build_cache(scene, s, soup, 1024, Key(3), n_walks=800)
    src = torch.rand((16384, 2), generator=g) * L
    pdf = torch.full((16384,), 1.0 / (L * L))
    ev = ev[:3]
    u, gr = tbvc.evaluate(scene, cache, ev, src, pdf, 16384,
                          radius_clamp=1e-3, kernel_regularization=0.05,
                          with_gradient=True)
    x, y = to_np(ev)[:, 0], to_np(ev)[:, 1]
    want = np.stack([-KX * np.sin(KX * x) * np.cos(KX * y),
                     -KX * np.cos(KX * x) * np.sin(KX * y)], -1)
    mc_close(gr, want, 0.2, "grad p")
    ub, gb = tbvc.evaluate(scene, cache, torch.tensor([[0.0, 1.0]]), src,
                           pdf, 16384, radius_clamp=1e-3,
                           kernel_regularization=0.05, with_gradient=True,
                           on_boundary=torch.tensor([True]))
    assert np.allclose(to_np(gb), 0.0)
    mc_close(ub, _p_star(np.asarray([[0.0, 1.0]])), 0.15, "p on the wall")
    # nonzero Neumann data: p* = cos(k x), flux -k sin(k L) on x = L
    k = math.pi / (2.0 * L)
    sc = t_solver.WostScene(
        dim=2, neumann=soup, absorption=SIGMA,
        source_fn=lambda x: (SIGMA + k ** 2) * torch.cos(k * x[..., 0]),
        neumann_fn=lambda x: torch.where(x[..., 0] > L - 1e-4,
                                         -k * torch.sin(k * x[..., 0]), 0.0))
    cache = tbvc.build_cache(sc, s, soup, 1024, Key(5), n_walks=800)
    dn = to_np(cache.normal_derivative)
    right = to_np(cache.pts)[:, 0] > L - 1e-4
    assert np.abs(dn[right] + k * np.sin(k * L)).max() < 1e-5
    assert np.allclose(dn[~right], 0.0)
    ev = torch.tensor([[1.0, 1.0], [1.5, 0.7], [0.4, 1.2]])
    u = tbvc.evaluate(sc, cache, ev, src, pdf, 16384, radius_clamp=1e-3,
                      kernel_regularization=0.05)
    mc_close(u, np.cos(k * to_np(ev)[:, 0]), 0.08, "p with flux data")


# ---------------------------------------------------------- the projector

def _wost_scene(scene, jax_side):
    ss = scene.scene_size
    if jax_side:
        return j_solver.WostScene(
            dim=2, neumann=scene.boundary, absorption=scene.absorption,
            source_fn=lambda y, g: j_sampling.nearest_lookup(g, ss, y))
    return t_solver.WostScene(
        dim=2, neumann=scene.boundary, absorption=scene.absorption,
        source_fn=lambda y, g: t_sampling.nearest_lookup(g, ss, y))


@pytest.fixture(scope="module")
def tg_projectors():
    """tests/test_bvcproj.py's TG projector (128 cells, 512 cache points,
    eval chunks of 1024) in both packages, 256 walks for the parity."""
    js, ts = j_get_scene("taylorgreen"), t_get_scene("taylorgreen")
    kw = dict(n_boundary=512, eval_chunk=1024)
    jb = jbem.BvcProjector(js, 128, _wost_scene(js, True),
                           js.walk_settings(n_walks=256), **kw)
    tb = tbem.BvcProjector(ts, 128, _wost_scene(ts, False),
                           ts.walk_settings(n_walks=256), **kw)
    return jb, tb


def test_bvc_projector_matches_jax(tg_projectors):
    """The projector's cache and offset points, then one solve of the
    manufactured Neumann grid at 512 points on the same key: the cache
    walk on the same streams, the same splat."""
    jb, tb = tg_projectors
    assert tb.A_inv is None and jb.A_inv is None
    np.testing.assert_allclose(to_np(tb.inner_pts), np.asarray(jb.inner_pts),
                               rtol=1e-6, atol=1e-7)
    ss = tb.scene.scene_size
    lo = ss[0]
    k = 2 * np.pi / (ss[1] - lo)
    hx, hy = tb.spacing
    X, Y = np.meshgrid(ss[0] + (np.arange(tb.res[0]) + 0.5) * hx,
                       ss[2] + (np.arange(tb.res[1]) + 0.5) * hy,
                       indexing="ij")
    g = ((2 * k ** 2 + 350.0) * np.cos(k * (X - lo)) * np.cos(k * (Y - lo))
         ).astype(np.float32)
    pts = np.random.RandomState(0).uniform(ss[0], ss[1], (512, 2)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    pj, gj = jb.solve(jnp.asarray(g), jnp.asarray(pts), key)
    pt, gt = tb.solve(torch.from_numpy(g), torch.from_numpy(pts),
                      JaxKey(key))
    close(pt, pj, 2e-4)
    close(gt, gj, 2e-4)


def test_bvc_projector_manufactured():
    """tests/test_bvcproj.py on the port alone at its sizes (1024 walks):
    the constant solution (atol 0.02; the gradient under 0.1 away from
    the wall) and the Neumann-exact cos(k x) cos(k y) (0.02 in the bulk,
    0.15 for the gradient, 0.06 everywhere)."""
    sc = t_get_scene("taylorgreen")
    bp = tbem.BvcProjector(sc, 128, _wost_scene(sc, False),
                           sc.walk_settings(n_walks=1024), n_boundary=512,
                           eval_chunk=1024)
    ss = sc.scene_size
    lo, hi = ss[0], ss[1]
    gen = np.random.RandomState(1)
    pts = gen.uniform(lo, hi, (512, 2)).astype(np.float32)
    p, gp = bp.solve(torch.full(bp.res, sc.absorption), torch.from_numpy(pts),
                     Key(7))
    mc_close(p, np.ones(len(pts)), 0.02, "constant p")
    d = np.minimum.reduce([pts[:, 0] - lo, hi - pts[:, 0],
                           pts[:, 1] - lo, hi - pts[:, 1]])
    mc_below(np.abs(to_np(gp))[d > 0.05].max(), 0.1, "constant's grad p")
    k = 2 * np.pi / (hi - lo)
    hx, hy = bp.spacing
    X, Y = np.meshgrid(lo + (np.arange(bp.res[0]) + 0.5) * hx,
                       lo + (np.arange(bp.res[1]) + 0.5) * hy, indexing="ij")
    us = lambda x, y: np.cos(k * (x - lo)) * np.cos(k * (y - lo))
    g = ((2 * k ** 2 + sc.absorption) * us(X, Y)).astype(np.float32)
    pts = gen.uniform(lo, hi, (2048, 2)).astype(np.float32)
    p, gp = bp.solve(torch.from_numpy(g), torch.from_numpy(pts), Key(9))
    ut = us(pts[:, 0], pts[:, 1])
    gt = np.stack([-k * np.sin(k * (pts[:, 0] - lo)) * np.cos(k * (pts[:, 1]
                                                                   - lo)),
                   -k * np.cos(k * (pts[:, 0] - lo)) * np.sin(k * (pts[:, 1]
                                                                   - lo))],
                  -1)
    d = np.minimum.reduce([pts[:, 0] - lo, hi - pts[:, 0],
                           pts[:, 1] - lo, hi - pts[:, 1]])
    m = d > 0.05
    mc_below(np.abs(to_np(p)[m] - ut[m]).max(), 0.02, "bulk p")
    mc_below(np.abs(to_np(gp)[m] - gt[m]).max(), 0.15, "bulk grad p")
    mc_below(np.abs(to_np(p) - ut).max(), 0.06, "p everywhere")


SOLVE_SIZES = dict(sample_resolution=8, wost_resolution=32, n_walks=48,
                   max_n_iters=20, fit_pool=4, div_resolution=48)


@pytest.mark.parametrize("name", ["taylorgreen", "karman"])
def test_pressure_solve_bvc_matches_jax(name):
    """`_pressure_solve_bvc` on one divergence grid and one key: the same
    cloud, and p and grad p after the masking at the walk's tolerance of
    their magnitude."""
    jf = jfluid.NeuralFluid(j_get_scene(name), projection="bvc",
                            **SOLVE_SIZES)
    tf = tfluid.NeuralFluid(t_get_scene(name), projection="bvc",
                            device="cpu", **SOLVE_SIZES)
    bj = jbem.BvcProjector(jf.scene, 48, jf._wost_scene, jf.walk_settings)
    bt = tbem.BvcProjector(tf.scene, 48, tf._wost_scene, tf.walk_settings)
    div = np.random.RandomState(6).randn(*bj.res).astype(np.float32)
    key = jax.random.PRNGKey(5)
    pts_j, valid_j, p_j, g_j = jfluid._pressure_solve_bvc(
        jf, bj, jnp.asarray(div), key)
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve_bvc(
        tf, bt, torch.tensor(div), JaxKey(key))
    np.testing.assert_allclose(to_np(pts_t), np.asarray(pts_j), rtol=2e-7,
                               atol=2.4e-7)
    np.testing.assert_array_equal(to_np(valid_t), np.asarray(valid_j))
    close(p_t, p_j, 2e-4)
    close(g_t, g_j, 2e-4)


def test_bvc_cache_walk_does_not_depend_on_the_generation_width():
    """chip_smoke.py walks karman's bvc cache in generations of 64 pairs
    (BVC_GROUP_PAIRS) in place of the scene's 4: the same walks on the
    same streams, so the cached solution and the valid walks a point are
    the 4-pair run's, the solution up to the order of its float sums (the
    gradient, which the cache does not keep, moves with the control
    variates' warm-up, which the group size rounds up)."""
    f = tfluid.NeuralFluid(t_get_scene("karman"), projection="bvc",
                           device="cpu", **SOLVE_SIZES)
    bt = tbem.BvcProjector(f.scene, 48, f._wost_scene, f.walk_settings,
                           n_boundary=64)
    div = torch.tensor(np.random.RandomState(6).randn(*bt.res)
                       .astype(np.float32))
    out = {}
    for G in (4, 64):
        ws = dataclasses.replace(f.walk_settings, gen_group_pairs=G)
        out[G] = t_solver.estimate_solution_and_gradient(
            f._wost_scene, ws, bt.inner_pts, Key(3), n_walks=128,
            source_args=(div,))
    assert torch.equal(out[64][2], out[4][2])
    torch.testing.assert_close(out[64][0], out[4][0], rtol=1e-6, atol=1e-8)


@pytest.fixture(scope="module")
def tg_step():
    """One Taylor-Green step under projection="bvc" in both packages from
    the same initial weights (init_state(0); the JAX package's fused fit
    in interpret mode, the port's plain twin, the JAX-replay key), with
    each phase fit's output params logged."""
    sizes = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
                 n_walks=48, max_n_iters=20, fit_pool=4, projection="bvc")
    logs = {"jax": {"fits": [], "branch": [], "init": [], "pressure": []},
            "torch": {"fits": [], "branch": [], "init": []}}
    with pytest.MonkeyPatch.context() as mp:
        _record(mp, jfluid, logs["jax"], True)
        _record(mp, tfluid, logs["torch"], False)
        jf = jfluid.NeuralFluid(j_get_scene("taylorgreen"), fit_mode="fused",
                                **sizes)
        js = jf.step(jf.init_state(0))
        jax.effects_barrier()
        tf = tfluid.NeuralFluid(t_get_scene("taylorgreen"), device="cpu",
                                **sizes)
        ts = tf.step(tf.init_state(key=JaxKey.from_seed(0)))
    return jf, js, tf, ts, logs


def test_tg_step_under_bvc_matches_jax(tg_step):
    """Each fit at the TG-family fit tolerance (rtol 2e-4 / atol 1e-3, as
    under bem in tests/test_torch_bem.py), the same ls_head branches, the
    final params and P, the same cache size."""
    jf, js, tf, ts, logs = tg_step
    assert [n for n, _ in logs["torch"]["fits"]] == ["_fit_advect",
                                                     "_fit_project"]
    for (_, pj), (_, pt) in zip(logs["jax"]["fits"], logs["torch"]["fits"]):
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-3)
    assert logs["torch"]["branch"] == logs["jax"]["branch"]
    for a, b in zip(params_np(ts.params), params_np(js.params)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(float(ts.P), float(js.P), rtol=1e-3,
                               atol=1e-6)
    assert tf._bvc.n_boundary == jf._bvc.n_boundary


def test_karman_step_under_bvc_and_pool():
    """tests/test_bvcproj.py::test_fluid_step_with_bvc_projection on the
    port, under both executors: finite params, P and pressure, the walk
    and splat timed apart, and the same P from gen and pool (the cache
    walk takes the same streams)."""
    sc = t_get_scene("karman")
    P = {}
    for algo in ("gen", "pool"):
        f = tfluid.NeuralFluid(sc, max_n_iters=20, sample_resolution=8,
                               wost_resolution=16, div_resolution=64,
                               projection="bvc", device="cpu", fit_pool=4,
                               walk_settings=sc.walk_settings(n_walks=64,
                                                              algo=algo))
        f.profile = True
        s = f.add_source(f.init_state(0))
        s = f.step(s._replace(eps=sc.eps_after_source(s.eps)))
        assert {"bvc_walk", "bvc_splat"} <= set(f.stage_times)
        _, p, gp, _ = f._last_projection
        for a in [s.P, p, gp] + [t for pair in s.params for t in pair]:
            assert bool(torch.isfinite(a).all())
        P[algo] = float(s.P)
    np.testing.assert_allclose(P["pool"], P["gen"], rtol=2e-4, atol=2e-7)


def test_multiloop_bem_and_bvc_match_the_walk():
    """tests/test_multicyl.py::test_bem_multiloop_matches_wost on the
    port's karman2cyl (the box and two cylinder loops), with bvc as a
    third solver: at 16 points away from the walls and cylinders, the
    Nystrom solve and the boundary-value cache each within 0.12 of the
    walk's largest |p| of the walk's estimate (256 walks each). The
    points and the walk take the JAX test's keys through the replay key,
    so the port walks the JAX test's walks."""
    sc = t_get_scene("karman2cyl")
    ss = sc.scene_size
    bem = tbem.BemProjector(sc, 160, n_boundary=1536, eval_chunk=512)
    wsc = _wost_scene(sc, False)
    bvc = tbem.BvcProjector(sc, 160, wsc, sc.walk_settings(n_walks=256),
                            n_boundary=1536, eval_chunk=512)
    hx, hy = bem.spacing
    X, Y = np.meshgrid(ss[0] + (np.arange(bem.res[0]) + 0.5) * hx,
                       ss[2] + (np.arange(bem.res[1]) + 0.5) * hy,
                       indexing="ij")
    g = torch.tensor(np.sin(2.0 * X + 0.5) * np.cos(2.5 * Y),
                     dtype=torch.float32)
    pts, valid = t_sampling.fluid_points(JaxKey.from_seed(5), 512, sc)
    d = to_np(sc.obstacle_sdf(pts))
    walls = np.minimum(to_np(pts)[:, 1] - ss[2], ss[3] - to_np(pts)[:, 1])
    sel = to_np(valid) & (d > 0.08) & (walls > 0.08)
    pts_s = pts[torch.from_numpy(sel)][:16]
    p_b, _ = bem.solve(g, pts_s)
    p_c, _ = bvc.solve(g, pts_s, JaxKey.from_seed(13))
    p_w, _, _ = t_solver.estimate_solution(
        wsc, sc.walk_settings(n_walks=256), pts_s, JaxKey.from_seed(11),
        source_args=(g,))
    scale = float(p_w.abs().max())
    assert float((p_b - p_w).abs().max()) < 0.12 * scale
    assert float((p_c - p_w).abs().max()) < 0.12 * scale
