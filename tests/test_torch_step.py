"""The whole Taylor-Green slice: the port's add_source + step against the
JAX package's, on the CPU, at tiny width.

The port runs with the JAX-replay key seam, so it draws every random
number the JAX package draws: initial weights, training points, pool
batches, pressure clouds, walk streams and projection minibatches. The
JAX side runs its fused fit (the Pallas kernel in interpret mode). Each
phase fit's output is compared along the chained run, and the ls_head
do-no-harm branch of every fit must be the same.

The chained fits agree to the fit tolerance (atol 1e-3: Adam's first,
sign-like steps turn last-ulp gradient differences into O(lr) parameter
differences), and the divergence grid's seven sin(30 z) layers amplify
that past 1e-4. So the divergence grid and the pressure solve are held
to their tighter tolerances on the JAX run's own stage inputs: the
params after its advection fit, and its divergence grid and chunk key.
"""
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, chained_runs, params_np, to_np

import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.wost.solver import WalkSettings

TINY = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
            n_walks=48, max_n_iters=20, fit_pool=4)


@pytest.fixture(scope="module")
def runs():
    return chained_runs("taylorgreen", TINY)


def test_each_fit_matches(runs):
    """Params after the source, advection and projection fits: rtol 2e-4
    / atol 1e-3, the TG-family fit tolerance (tests/test_fitkernel.py)."""
    *_, logs = runs
    names = [n for n, _ in logs["jax"]["fits"]]
    assert names == ["_fit_source", "_fit_advect", "_fit_project"]
    assert names == [n for n, _ in logs["torch"]["fits"]]
    for (_, pj), (_, pt) in zip(logs["jax"]["fits"], logs["torch"]["fits"]):
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-3)


def test_ls_head_branch_is_equal(runs):
    *_, logs = runs
    assert len(logs["jax"]["branch"]) == 3
    assert logs["torch"]["branch"] == logs["jax"]["branch"]


def test_divergence_grid_matches(runs):
    """On the params the JAX run projected (its advection fit's output):
    rtol 1e-4 / atol 5e-5. Both sides take an f32 forward-mode Jacobian
    through seven sin(30 z) layers, with partials up to ~1.8. Against a
    float64 evaluation of the same grid, the JAX package's f32 grid is
    off by up to 3.4e-5 and the port's by up to 1.6e-5, so an atol of
    1e-5 between the two would measure f32 rounding, not the port."""
    jf, js, tf, ts, logs = runs
    prev = [tuple(torch.tensor(a) for a in pair) for pair in zip(
        *[iter(logs["jax"]["fits"][1][1])] * 2)]
    got = tfluid._divergence_grid(tf, prev, ts.eps, 1)
    np.testing.assert_allclose(to_np(got), np.asarray(jf._last_projection[3]),
                               rtol=1e-4, atol=5e-5)


def test_pressure_matches(runs):
    """One chunk on the JAX run's divergence grid and chunk key: the same
    pressure cloud (to an ulp: XLA may fuse lo + u (hi - lo) into an FMA),
    and p / grad p at the gen-vs-pool tolerances of tests/test_gen.py."""
    jf, js, tf, ts, logs = runs
    assert len(logs["jax"]["pressure"]) == 1
    grid, key, (pts_j, valid_j, p_j, g_j) = logs["jax"]["pressure"][0]
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve(
        tf, (torch.from_numpy(grid),), JaxKey(key))
    np.testing.assert_allclose(to_np(pts_t), pts_j, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(to_np(valid_t), valid_j)
    np.testing.assert_allclose(to_np(p_t), p_j, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(to_np(g_t), g_j, rtol=2e-3, atol=2e-4)


def test_final_state(runs):
    jf, js, tf, ts, _ = runs
    assert ts.timestep == int(js.timestep) == 1
    assert np.isfinite(float(ts.P))
    for a, b in zip(params_np(ts.params), params_np(js.params)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("over", [dict(fit_ensemble=2),
                                  dict(projection="bvc",
                                       walk_settings=WalkSettings(
                                           fast_rng=False)),
                                  dict(mesh=["cpu", "cpu"],
                                       fit_ensemble=2),
                                  dict(walk_settings=WalkSettings(
                                      algo="pool", adaptive_walks=1.0)),
                                  dict(walk_settings=WalkSettings(
                                      algo="lockstep")),
                                  dict(walk_settings=WalkSettings(
                                      fast_rng=False)),
                                  dict(wost_source="net",
                                       walk_settings=WalkSettings(
                                           algo="pool", adaptive_walks=1.0))])
def test_once_refused_flags_step(over, monkeypatch):
    """The flags once refused run a tiny add_source + step at TINY sizes:
    fit_ensemble 2 (two fits a phase, averaged: the fit count doubles),
    the lockstep gradient (algo "lockstep", and fast_rng=False, which
    routes there; under wost and under bvc, whose cache walk takes the
    fluid's executor) and adaptive allocation on the pool (its rounds
    counted), alone and beside a points mesh or the net source. Each
    step's P and weights are finite. tests/test_torch_lockstep.py holds
    these settings against the JAX package."""
    from nmcfluid_torch.wost import pool, solver
    over = dict(over)
    fits = []
    single = tfluid._adam_fit_single

    def counted(*a, **kw):
        fits.append(1)
        return single(*a, **kw)
    monkeypatch.setattr(tfluid, "_adam_fit_single", counted)
    solver.counts.update(dict.fromkeys(solver.counts, 0))
    pool.counts.update(dict.fromkeys(pool.counts, 0))
    fluid = tfluid.NeuralFluid(t_get_scene("taylorgreen"), device="cpu",
                               **dict(TINY, **over))
    state = fluid.step(fluid.add_source(fluid.init_state(0)))
    assert np.isfinite(float(state.P))
    assert all(np.all(np.isfinite(a)) for a in params_np(state.params))
    assert len(fits) == 3 * over.get("fit_ensemble", 1)
    ws = over.get("walk_settings", WalkSettings())
    lockstep = ws.algo == "lockstep" or not ws.fast_rng
    assert (solver.counts["passes"] > 0) == lockstep
    assert (pool.counts["rounds"] > 0) == (ws.adaptive_walks > 0.0)
