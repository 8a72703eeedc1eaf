"""The lockstep gradient executor (fast_rng=False routes there too) and
adaptive walk allocation on the pool, against the JAX package on the
CPU, and on the port alone against the JAX tests' manufactured problems.

Both packages take the same draws: the JAX-replay key for jax.random
(the first-sample draws, the rotation, and with fast_rng=False every walk
draw), fastrand for the fast walks' streams. Where the two agree to
reduction order the tolerances are tests/test_gen.py's (p rtol 2e-4 /
atol 2e-5, grad rtol 2e-3 / atol 2e-4); on the 3D triangle soups a walk
may take another path where a rounding error decides a silhouette, so
those estimates are held with walk_close (tests/test_torch_mixed3d.py).
The manufactured problems (tests/test_pool.py:83-200) are held at the
JAX tests' atol.
"""
import dataclasses

import jax  # noqa: F401  (JAX beside torch, on the CPU)
import numpy as np
import pytest
import torch

from _torch_parity import mc_below, mc_close, spread, to_np, walk_close
from test_torch_mixed3d import CASES as CASES_3D
from test_torch_mixed3d import LIBS as LIBS_3D
from test_torch_mixed3d import mixed_scene as mixed_scene_3d
from test_torch_walk_family import (G_TOL, KX, L, LIBS, P_TOL, PTS_D,
                                    _p_star, barrier_scene, mixed_scene)

from nmcfluid.geometry.analytic2d import make_analytic2d as j_analytic
from nmcfluid.wost import pool as j_pool

from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost import pool as t_pool
from nmcfluid_torch.wost import solver as t_solver

BARRIER_PTS = np.asarray([[0.4, 1.0], [1.3, 0.9], [0.7, 0.3], [1.8, 1.6]],
                         np.float32)
# the 2D problems: scene, settings, points
PROBLEMS = {
    "dirichlet": (lambda lib: mixed_scene(lib), {}, PTS_D),
    "barrier": (lambda lib: barrier_scene(lib, ds_data=True),
                dict(solve_double_sided=True), BARRIER_PTS),
    "neumann": (lambda lib: mixed_scene(lib, neumann_data=True), {}, PTS_D),
}
RNGS = {"fast": dict(algo="lockstep"), "threefry": dict(fast_rng=False)}


def _both(build, settings, pts, seed, n_walks):
    """estimate_solution_and_gradient in both packages on the same key."""
    out = {}
    for name, lib in LIBS.items():
        s = lib.solver.WalkSettings(**settings)
        out[name] = [to_np(a) for a in lib.solver.
                     estimate_solution_and_gradient(
                         build(lib), s, lib.arr(pts), lib.key(seed),
                         n_walks)]
    return out["torch"], out["jax"]


@pytest.mark.parametrize("rng", sorted(RNGS))
@pytest.mark.parametrize("case", sorted(PROBLEMS))
def test_lockstep_matches_jax(case, rng):
    """The lockstep gradient on the 2D mixed box (Dirichlet data; nonzero
    Neumann data) and the double-sided barrier with side-dependent data,
    under both RNGs: 24 walks, the same walks in both packages, so equal
    valid counts and p and grad p at the gen tolerances."""
    build, over, pts = PROBLEMS[case]
    settings = dict(ignore_dirichlet=False, walk_step_cap=96, **over,
                    **RNGS[rng])
    (pt, gt, nt), (pj, gj, nj) = _both(build, settings, pts, 2, 24)
    np.testing.assert_array_equal(nt, nj)
    assert np.all(nt > 0)
    np.testing.assert_allclose(pt, pj, **P_TOL)
    np.testing.assert_allclose(gt, gj, **G_TOL)


@pytest.mark.parametrize("rng", sorted(RNGS))
def test_pair_batches_match_jax(rng):
    """pair_batch 3 with pairs_per_launch 8 on 16 pairs: two launches of
    8 pairs, each in batches of 3, 3 and 2 (the launch's end cuts the
    last), the control variates refreshed at each batch's start:
    the JAX package's numbers; and they differ from pair_batch 1's. The
    antithetic pairs are off: with both halves of a pair valid the
    control variates cancel in its sum, so only unpaired walks show the
    refresh points (16 walks, one a pair)."""
    build, _, pts = PROBLEMS["neumann"]
    settings = dict(ignore_dirichlet=False, walk_step_cap=96, pair_batch=3,
                    pairs_per_launch=8, use_gradient_antithetic_variates=False,
                    **RNGS[rng])
    assert t_solver._pair_batches(t_solver.WalkSettings(**settings), 16) \
        == [(0, 3), (3, 6), (6, 8), (8, 11), (11, 14), (14, 16)]
    (pt, gt, nt), (pj, gj, nj) = _both(build, settings, pts, 3, 16)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(pt, pj, **P_TOL)
    np.testing.assert_allclose(gt, gj, **G_TOL)
    lib = LIBS["torch"]
    _, g1, _ = t_solver.estimate_solution_and_gradient(
        build(lib), t_solver.WalkSettings(**dict(settings, pair_batch=1)),
        lib.arr(pts), lib.key(3), 16)
    assert not np.allclose(to_np(g1), gt, **G_TOL)


@pytest.mark.parametrize("rng", sorted(RNGS))
def test_lockstep_3d_matches_jax(rng):
    """The lockstep gradient on tests/test_mixed3d.py's box (Neumann x/y
    walls with a flux, Dirichlet z walls, triangle soups), both RNGs, 16
    walks: walk_close at the gen tolerances, the walk's spread from a
    second key."""
    pts = np.asarray(CASES_3D["mixed"][2], np.float32)
    out = {}
    for name, lib in LIBS_3D.items():
        s = lib.solver.WalkSettings(ignore_dirichlet=False,
                                    walk_step_cap=128, **RNGS[rng])
        scene = mixed_scene_3d(lib, flux=True)[0]
        out[name] = [to_np(a) for a in lib.solver.
                     estimate_solution_and_gradient(scene, s, lib.arr(pts),
                                                    lib.key(4), 16)]
        if not lib.jax:
            other = [to_np(a) for a in lib.solver.
                     estimate_solution_and_gradient(
                         scene, s, lib.arr(pts), lib.key(5), 16)]
    (pt, gt, nt), (pj, gj, nj) = out["torch"], out["jax"]
    assert np.all(nt > 0) and np.abs(nt - nj).max() <= 1
    walk_close(pt, pj, spread(pt, other[0]), **P_TOL)
    walk_close(gt, gj, spread(gt, other[1]), **G_TOL)


# ------------------------------------------------ adaptive allocation

def _obstacle(lib):
    """The port's obstacle scene (pool.obstacle_scene, tests/test_pool.py:
    156-200's: an open channel with a circle, sigma 350) and its 8
    near-obstacle and 24 far points; the JAX side built alike on the same
    points."""
    scene, pts = t_pool.obstacle_scene("cpu")
    pts = pts.numpy()
    if not lib.jax:
        return scene, pts
    geom = j_analytic((-1e6, 0.0), (1e6, 2.0), circles=[(2.0, 1.0, 0.25)],
                      sil_pts=[(0.0, 0.0), (8.0, 0.0), (0.0, 2.0),
                               (8.0, 2.0)],
                      bbox=((0.0, 0.0), (8.0, 2.0)))
    return lib.solver.WostScene(
        dim=2, neumann=geom, absorption=350.0,
        source_fn=lambda x: lib.np.sin(x[..., 0]) * lib.np.cos(2.0
                                                               * x[..., 1])), pts


def test_adaptive_pool_matches_jax(monkeypatch):
    """The adaptive pool on the obstacle scene (500 walks, kappa 1): each
    round's alive set equals the JAX package's, or where a point's stop
    decision differs its target sits within 1e-4 of the round's pair
    count (the sums differ in reduction order); then equal valid counts
    and p and grad p at the gen tolerances. Some points stop early, and
    the pool's counts record each round's alive points."""
    rounds = {"jax": [], "torch": []}
    j_launch, t_launch = j_pool._pool_launch, t_pool._pool_launch

    def j_wrap(*a):
        # (.., g_hi, cv, carry, n_active, active_idx, ..): one entry a round
        n_active, g_hi = int(a[11]), int(a[8])
        if not rounds["jax"] or rounds["jax"][-1][0] != g_hi:
            rounds["jax"].append((g_hi, np.asarray(a[12])[:n_active].copy(),
                                  np.asarray(a[10].acc).copy()))
        return j_launch(*a)

    def t_wrap(*a):
        active = a[13]
        rounds["torch"].append((a[7], np.arange(a[4]) if active is None
                                else active.numpy().copy(), None))
        return t_launch(*a)
    monkeypatch.setattr(j_pool, "_pool_launch", j_wrap)
    monkeypatch.setattr(t_pool, "_pool_launch", t_wrap)
    t_pool.counts.update(dict.fromkeys(t_pool.counts, 0))
    out = {}
    for name, lib in LIBS.items():
        scene, pts = _obstacle(lib)
        s = lib.solver.WalkSettings(walk_step_cap=64, adaptive_walks=1.0)
        out[name] = [to_np(a) for a in lib.solver.
                     estimate_solution_and_gradient(scene, s, lib.arr(pts),
                                                    lib.key(1), 500)]
    assert [r[0] for r in rounds["torch"]] == [r[0] for r in rounds["jax"]]
    alive = [len(r[1]) for r in rounds["torch"]]
    assert len(alive) == 4 and alive[-1] < 32
    assert t_pool.counts["rounds"] == 3
    assert t_pool.counts["alive"] == sum(alive[1:])
    # a round's first pair: the end of the round before it
    los = [0] + [g_hi // (2 * len(a)) for g_hi, a, _ in rounds["jax"]]
    for lo, (_, at, _), (_, aj, acc) in zip(los, rounds["torch"],
                                            rounds["jax"]):
        differ = np.setxor1d(at, aj)
        if differ.size:
            tgt = t_pool._adaptive_targets(acc, 2, 250, 1.0)[differ]
            assert np.all(np.abs(lo - tgt) / tgt < 1e-4), (differ, tgt)
    (pt, gt, nt), (pj, gj, nj) = out["torch"], out["jax"]
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(pt, pj, **P_TOL)
    np.testing.assert_allclose(gt, gj, **G_TOL)


# ------------------------------------------------ manufactured problems

def _box():
    """tests/test_pool.py's box: a 16-segment soup, sigma 30, p* = cos(KX
    x) cos(KX y)."""
    lib = LIBS["torch"]
    soup = lib.soup.build_segments(
        [lib.soup.box_loop(0.0, L, 0.0, L, n_per_side=4)])
    return t_solver.WostScene(
        dim=2, neumann=soup, absorption=30.0,
        source_fn=lambda x: (30.0 + 2 * KX ** 2) * _p_star(lib, x))


def _grad_star(x):
    x = torch.as_tensor(x)
    return torch.stack([-KX * torch.sin(KX * x[:, 0]) * torch.cos(KX * x[:, 1]),
                        -KX * torch.cos(KX * x[:, 0]) * torch.sin(KX * x[:, 1])],
                       -1)


def _pts192():
    return torch.from_numpy(np.random.default_rng(3).uniform(
        0.3, 1.7, (192, 2)).astype(np.float32))


def test_pool_agrees_with_lockstep():
    """tests/test_pool.py:83-92: the lockstep gradient (step cap 96) and
    the pool are independent realizations of one estimator: at 192
    points x 256 walks their means agree, mean |dp| < 0.02 and mean
    |d grad p| < 0.12."""
    scene, pts = _box(), _pts192()
    lk = t_solver.WalkSettings(n_walks=256, algo="lockstep",
                               walk_step_cap=96)
    pl = t_solver.WalkSettings(n_walks=256, algo="pool")
    p_a, g_a, _ = t_solver.estimate_solution_and_gradient(scene, lk, pts,
                                                          Key(5))
    p_b, g_b, _ = t_solver.estimate_solution_and_gradient(scene, pl, pts,
                                                          Key(5))
    mc_below((p_a - p_b).abs().mean(), 0.02, "mean |dp|")
    mc_below((g_a - g_b).abs().mean(), 0.12, "mean |d grad p|")


def test_lockstep_antithetic_and_cv_reduce_variance():
    """tests/test_pool.py:95-108 on the lockstep executor (the role of
    tests/test_wost.py's variance test): with the antithetic pairs and
    the control variates the gradient's squared error at 192 points x
    128 walks is below the plain estimator's."""
    scene, pts = _box(), _pts192()
    full = t_solver.WalkSettings(n_walks=128, algo="lockstep",
                                 walk_step_cap=96)
    plain = dataclasses.replace(full, use_gradient_antithetic_variates=False,
                                use_gradient_control_variates=False)
    want = _grad_star(pts)
    _, g_full, _ = t_solver.estimate_solution_and_gradient(scene, full, pts,
                                                           Key(9))
    _, g_plain, _ = t_solver.estimate_solution_and_gradient(scene, plain, pts,
                                                            Key(9))
    mc_below(((g_full - want) ** 2).mean(), ((g_plain - want) ** 2).mean(),
             "the variates' squared error below the plain one's")


def test_adaptive_walks_accuracy_and_savings():
    """tests/test_pool.py:110-154: at 6 points x 4000 walks, the fixed
    estimate within atol 0.05 of p*, the adaptive one within 0.08 and its
    x-gradient within 0.2; on this variance-homogeneous box the
    allocation stays near uniform: over 0.8 of the fixed run's walks, at
    least 16 a point. 4096 pool slots only reorder the work."""
    scene = _box()
    pts = torch.tensor([[1.0, 1.0], [0.5, 0.7], [1.5, 0.3], [0.25, 1.7],
                        [0.9, 1.3], [1.7, 1.7]])
    fixed = t_solver.WalkSettings(walk_step_cap=96, pool_slots=4096)
    adapt = dataclasses.replace(fixed, adaptive_walks=1.0)
    p_f, _, n_f = t_solver.estimate_solution_and_gradient(scene, fixed, pts,
                                                          Key(0), 4000)
    p_a, g_a, n_a = t_solver.estimate_solution_and_gradient(scene, adapt,
                                                            pts, Key(0), 4000)
    want = _p_star(LIBS["torch"], pts)
    mc_close(p_f, want, 0.05, "fixed p")
    mc_close(p_a, want, 0.08, "adaptive p")
    mc_close(to_np(g_a)[:, 0], to_np(_grad_star(pts))[:, 0], 0.2,
             "adaptive d p / d x")
    assert int(n_a.sum()) > 0.8 * int(n_f.sum()), (n_a, n_f)
    assert int(n_a.min()) >= 16


def test_adaptive_walks_concentrate_at_the_obstacle():
    """tests/test_pool.py:156-200: on the obstacle scene at 500 walks the
    adaptive allocation keeps the near-silhouette points at (almost) the
    full budget (median >= 0.9 x the fixed run's), cuts a quarter of the
    far field below half (25th percentile < 0.5 x the fixed median) and
    the total below 0.85 x the fixed run's. The near points sit 0.005
    from the circle (0.255 from its centre, at the scene's angles) where
    tests/test_pool.py puts them 0.05 away: there the toy saves 17% on
    average, at its 15% bound, and 10 of 48 keys read over it
    (port_key_audit.py); 0.005 away it saves 44% and no key of 48 reads
    over 0.8 of a bound (docs/key_audit_torch_r16.json).
    250 pairs a generation only reorder the fixed run's work."""
    scene, pts = _obstacle(LIBS["torch"])
    pts = torch.from_numpy(pts)
    centre = torch.tensor([2.0, 1.0])
    pts[:8] = centre + (pts[:8] - centre) * (0.255 / 0.30)
    fixed = t_solver.WalkSettings(walk_step_cap=64, gen_group_pairs=250)
    adapt = dataclasses.replace(fixed, adaptive_walks=1.0)
    _, _, n_f = t_solver.estimate_solution_and_gradient(scene, fixed, pts,
                                                        Key(1), 500)
    _, _, n_a = t_solver.estimate_solution_and_gradient(scene, adapt, pts,
                                                        Key(1), 500)
    n_a, n_f = to_np(n_a), to_np(n_f)
    assert np.median(n_a[:8]) >= 0.9 * np.median(n_f[:8]), n_a
    mc_below(np.percentile(n_a[8:], 25), 0.5 * np.median(n_f[8:]),
             "far-field walks")
    mc_below(n_a.sum(), 0.85 * n_f.sum(), "total walks")
