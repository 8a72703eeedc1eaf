"""The 3D slice as a whole: the port's add_source + step against the JAX
package's, on the CPU, at tiny resolutions with the scenes' full-width
nets (smoke's 5 x 64, karman3d's 2 x 128).

As in tests/test_torch_step.py, the port runs with the JAX-replay key, so
it draws every random number the JAX package draws, smoke's time-seeded
jet jitter (the fixed key of seed 7 folded with the timestep) among them;
the JAX side runs its fused fit (the Pallas kernel in interpret mode).
Each phase fit's output is compared along the chained run, and the
divergence grid and the pressure chunk on the JAX run's own stage inputs.
smoke_obs and vortex_collide, whose modules tests/test_torch_3d.py holds
against JAX, run a tiny step of the port alone.
"""
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, chained_runs, mc_below, params_np, to_np

import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid_torch.models.siren import params_from_numpy
from nmcfluid_torch.scenes import get_scene as t_get_scene

TINY = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
            n_walks=48, max_n_iters=20, fit_pool=4)


@pytest.fixture(scope="module", params=["smoke", "karman3d"])
def runs(request):
    return request.param, chained_runs(request.param, TINY)


def _assert_fit_close(name, got, want):
    """smoke's 5 x 64 net at the deep family's fit tolerance, rtol 2e-4 /
    atol 1e-3 (tests/test_fitkernel.py; Adam's first, sign-like steps turn
    last-ulp gradient differences into O(lr) moves). karman3d's 2 x 128
    net as karman's (tests/test_torch_karman.py): the trunk at rtol 2e-4 /
    atol 2e-6 and the head's W at atol 3e-5, the float32 noise of the
    ls_head eigensolve near its cutoff."""
    for i, (a, b) in enumerate(zip(got, want)):
        head_w = i == len(got) - 2
        atol = 1e-3 if name == "smoke" else 3e-5 if head_w else 2e-6
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=atol)


def test_3d_each_fit_matches(runs):
    """Params after the source, advection and projection fits, each phase
    from fresh weights drawn from JAX's keys, and the same ls_head
    branches."""
    name, (*_, logs) = runs
    names = [n for n, _ in logs["jax"]["fits"]]
    assert names == ["_fit_source", "_fit_advect", "_fit_project"]
    assert names == [n for n, _ in logs["torch"]["fits"]]
    for (_, pj), (_, pt) in zip(logs["jax"]["fits"], logs["torch"]["fits"]):
        _assert_fit_close(name, pt, pj)
    assert len(logs["jax"]["branch"]) == 3
    assert logs["torch"]["branch"] == logs["jax"]["branch"]
    assert len(logs["jax"]["init"]) == len(logs["torch"]["init"]) == 2
    for pj, pt in zip(logs["jax"]["init"], logs["torch"]["init"]):
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)


def test_3d_projection_stages_match(runs):
    """On the JAX run's own stage inputs (its advection fit's params, its
    divergence grid and chunk key): the 16^3 divergence grid at rtol 1e-4
    / atol 5e-5 (tests/test_torch_step.py), the same pressure cloud to an
    ulp of the cube's coordinates, equal valid flags (karman3d rejects
    points in its cylinder), and p / grad p at the gen-vs-pool tolerances
    of tests/test_gen.py."""
    name, (jf, js, tf, ts, logs) = runs
    prev = params_from_numpy(list(zip(*[iter(logs["jax"]["fits"][1][1])]
                                      * 2)))
    got = tfluid._divergence_grid(tf, prev, ts.eps, 1)
    assert got.shape == tf._last_projection[3].shape == (16, 16, 16)
    np.testing.assert_allclose(to_np(got), np.asarray(jf._last_projection[3]),
                               rtol=1e-4, atol=5e-5)
    assert len(logs["jax"]["pressure"]) == 1
    grid, key, (pts_j, valid_j, p_j, g_j) = logs["jax"]["pressure"][0]
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve(
        tf, (torch.from_numpy(grid),), JaxKey(key))
    np.testing.assert_allclose(to_np(pts_t), pts_j, rtol=0,
                               atol=float(np.spacing(np.float32(1.0))))
    np.testing.assert_array_equal(to_np(valid_t), valid_j)
    np.testing.assert_allclose(to_np(p_t), p_j, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(to_np(g_t), g_j, rtol=2e-3, atol=2e-4)
    assert np.abs(to_np(p_t)).max() > 0


def test_3d_final_state(runs):
    """The ramp width (not halved in 3D), the step count and the params
    after the step (_assert_fit_close); P and the kinetic energy finite."""
    name, (jf, js, tf, ts, _) = runs
    assert ts.timestep == int(js.timestep) == 1
    assert np.float32(ts.eps) == np.asarray(js.eps) == np.float32(1e-2)
    assert np.isfinite(float(ts.P))
    assert np.isfinite(float(tf.kinetic_energy(ts, resolution=12)))
    _assert_fit_close(name, params_np(ts.params), params_np(js.params))


@pytest.mark.parametrize("name", ["smoke_obs", "vortex_collide"])
def test_3d_tiny_step_of_the_port(name):
    """add_source + one step of the port alone at a tiny size: the
    shapes of the 16^3 divergence grid and the 256-point pressure cloud,
    finite params, P and grid, the step's two phase fits, and
    a source fit that moved the field toward the scene's source."""
    f = tfluid.NeuralFluid(t_get_scene(name), device="cpu", **TINY)
    s0 = f.init_state(0)
    s1 = f.add_source(s0)
    rng = np.random.default_rng(0)
    pts = np.concatenate([   # half of them around the jets
        rng.uniform(-0.9, 0.9, (1000, 3)),
        np.clip(rng.normal([0.1, 0.1, -0.3], 0.3, (1000, 3)), -0.9, 0.9)])
    pts = torch.from_numpy(pts.astype(np.float32))
    src = f.scene.source_velocity(pts)

    def err(state):
        u = f.velocity(state.params, pts, eps=state.eps, t=state.timestep)
        return float(torch.sum((u - src) ** 2) / torch.sum(src ** 2))
    mc_below(err(s1), err(s0), "source fit's error / the start's")
    s2 = f.step(s1)
    pts_p, p, grad_p, div = f._last_projection
    assert div.shape == (16, 16, 16) and p.shape == (256,)
    assert grad_p.shape == pts_p.shape == (256, 3)
    assert s2.timestep == 1 and len(f._last_stats) == 2
    for t in [s2.P, p, grad_p, div] + [a for pair in s2.params for a in pair]:
        assert torch.isfinite(t).all()
