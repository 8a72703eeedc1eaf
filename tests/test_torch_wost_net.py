"""The network-evaluated walk source (wost_source="net") against the JAX
package's and against the grid source, on the CPU.

Under "net" the walk's source term is -div u of the network, hard BCs
included, at each sampled point, by forward mode, where "grid" looks up
the divergence grid's nearest texel. The source itself is held to the
JAX package's (vmap of jacfwd, traced) at rtol 1e-4 / atol 5e-5, the
divergence grid's tolerance (tests/test_torch_step.py); one pressure
chunk under "net" to JAX's on the same key at the gen tolerances (p rtol
2e-4 / atol 2e-5, grad rtol 2e-3 / atol 2e-4); and the net source to the
grid source within the grid's own discretization error, by
tests/test_sim.py:92-124's quantile bounds. The network's Jacobian,
written out layer by layer, is held to torch.func.jacfwd. The CLI's
--wost_source net runs, and the bvc projection walks its cache with the
grid, as in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, params_np, to_np

import nmcfluid.sim.fluid as jfluid
import nmcfluid_torch.run as trun
import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.wost.solver import WalkSettings as JSettings
from nmcfluid_torch.models.siren import (SirenConfig, apply_siren,
                                         apply_siren_tangents, init_siren)
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost.solver import WalkSettings

TINY = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
            max_n_iters=10)


@pytest.fixture(scope="module")
def pair():
    """A TG fluid of each package at tiny width, the port's initial
    weights those of the JAX package (the JAX-replay key)."""
    jf = jfluid.NeuralFluid(j_get_scene("taylorgreen"), **TINY,
                            walk_settings=JSettings(n_walks=16))
    tf = tfluid.NeuralFluid(t_get_scene("taylorgreen"), **TINY,
                            walk_settings=WalkSettings(n_walks=16),
                            wost_source="net", device="cpu")
    js = jf.init_state(0)
    ts = tf.init_state(key=JaxKey.from_seed(0))
    for a, b in zip(params_np(ts.params), params_np(js.params)):
        np.testing.assert_array_equal(a, b)
    return jf, js, tf, ts


def test_net_source_matches_jax(pair):
    """-div u at sampled points of any lane shape (a generation's
    (G, 2, N), a compacted subset, none) against the JAX package's
    source_net."""
    jf, js, tf, ts = pair
    rng = np.random.default_rng(0)
    y = rng.uniform(0.0, 2 * np.pi, (2, 2, 24, 2)).astype(np.float32)
    for arr in (y, y.reshape(-1, 2)[:37], y[:0, 0, 0]):
        got = tf._wost_scene_net.source_fn(torch.from_numpy(arr), ts.params,
                                           ts.eps, 1)
        want = jf._wost_scene_net.source_fn(jnp.asarray(arr), js.params,
                                            js.eps, 1)
        assert got.shape == arr.shape[:-1]
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                                   atol=5e-5)


@pytest.mark.parametrize("nl", ["sine", "relu", "elu", "tanh"])
def test_siren_tangents_match_autograd(nl):
    """apply_siren_tangents (the network's Jacobian written out, which the
    net source and the divergence grid take) against torch.func.jacfwd
    at 64 points of a 3 x 32 net of each nonlinearity: the value equal,
    the Jacobian at rtol 1e-5 / atol 1e-5."""
    cfg = SirenConfig(3, 3, num_hidden_layers=3, hidden_features=32,
                      nonlinearity=nl)
    params = init_siren(Key(1), cfg)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (64, 3)).astype(np.float32))
    u, du = apply_siren_tangents(params, cfg, x)
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda p: apply_siren(params, cfg, p)))(x)       # (M, out, in)
    assert torch.equal(u, apply_siren(params, cfg, x))
    np.testing.assert_allclose(to_np(du), to_np(jac.permute(2, 0, 1)),
                               rtol=1e-5, atol=1e-5)


def test_net_chunk_matches_jax(pair):
    """One pressure chunk under the net source on the same key: the same
    cloud, p and grad p at the gen tolerances."""
    jf, js, tf, ts = pair
    key = jax.random.PRNGKey(3)
    pts_j, valid_j, p_j, g_j = jfluid._pressure_solve(
        jf, jf._wost_scene_net, (js.params, js.eps, 1), key)
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve(
        tf, (ts.params, ts.eps, 1), JaxKey(key), tf._wost_scene_net)
    np.testing.assert_allclose(to_np(pts_t), np.asarray(pts_j), rtol=2e-7,
                               atol=0)
    np.testing.assert_array_equal(to_np(valid_t), np.asarray(valid_j))
    np.testing.assert_allclose(to_np(p_t), np.asarray(p_j), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(to_np(g_t), np.asarray(g_j), rtol=2e-3,
                               atol=2e-4)


def test_wost_source_net_matches_grid():
    """tests/test_sim.py:92-124 on the port, from the JAX test's seeds
    (the JAX-replay key: its initial weights and its walk key) and a
    400-iteration source fit (the fused fit's CPU twin on a 32-batch
    pool): the net source against the 256^2 grid's nearest texel on the
    same key (the same walks; only the source values differ): the same
    cloud, p within 0.12 of its scale at the 95th percentile and 0.1 on
    average, grad p within 0.15 at the 95th percentile and 0.05 at the
    median."""
    scene = t_get_scene("taylorgreen")
    fl = tfluid.NeuralFluid(
        scene, max_n_iters=400, sample_resolution=16, wost_resolution=16,
        div_resolution=256, fit_pool=32, device="cpu",
        walk_settings=WalkSettings(n_walks=64, walk_step_cap=16))
    st = fl.add_source(fl.init_state(key=JaxKey.from_seed(0)))
    div = tfluid._divergence_grid(fl, st.params, st.eps, st.timestep)
    key = JaxKey.from_seed(4)
    pts_g, _, p_g, g_g = tfluid._pressure_solve(fl, (div,), key)
    pts_n, _, p_n, g_n = tfluid._pressure_solve(
        fl, (st.params, st.eps, st.timestep), key, fl._wost_scene_net)
    assert torch.equal(pts_g, pts_n)
    dp = to_np((p_g - p_n).abs())
    scale = max(1e-6, float(p_g.abs().max()))
    assert float(np.percentile(dp, 95)) < 0.12 * scale, dp.max()
    assert float(dp.mean()) < 0.1 * scale
    dg = to_np((g_g - g_n).abs())
    gscale = max(1e-6, float(g_g.abs().max()))
    assert float(np.percentile(dg, 95)) < 0.15 * gscale
    assert float(np.median(dg)) < 0.05 * gscale


def test_step_routes_the_source(monkeypatch):
    """Under wost the step walks the net scene with (params, eps, t) and
    never the grid's lookup; under bvc the cache walk keeps the grid
    scene, as the JAX package does."""
    seen = []
    solve = tfluid._pressure_solve

    def spy(fluid, source_args, key, wsc=None):
        seen.append((wsc, len(source_args)))
        return solve(fluid, source_args, key, wsc)
    monkeypatch.setattr(tfluid, "_pressure_solve", spy)
    fl = tfluid.NeuralFluid(t_get_scene("taylorgreen"), **TINY,
                            n_walks=8, fit_pool=4, wost_source="net",
                            device="cpu")
    st = fl.step(fl.init_state(0))
    assert seen == [(fl._wost_scene_net, 3)] and np.isfinite(float(st.P))
    bvc = tfluid.NeuralFluid(t_get_scene("taylorgreen"), **TINY,
                             n_walks=8, fit_pool=4, wost_source="net",
                             projection="bvc", device="cpu")
    bvc.step(bvc.init_state(0))
    assert bvc._bvc.wost_scene is bvc._wost_scene


def test_cli_wost_source_net(tmp_path):
    """python -m nmcfluid_torch.run taylorgreen --wost_source net --device
    cpu at tiny flags: add_source and one step, both checkpoints."""
    trun.main(["taylorgreen", "--wost_source", "net", "--device", "cpu",
               "--n_timesteps", "1", "--max_n_iters", "10",
               "--sample_resolution", "8", "--wost_resolution", "8",
               "--div_resolution", "16", "--n_walks", "8", "--fit_pool",
               "4", "--out", str(tmp_path)])
    model = tmp_path / "taylorgreen" / "model"
    assert sorted(p.name for p in model.iterdir()) == [
        "ckpt_step_t000.npz", "ckpt_step_t001.npz"]
    cfg = (tmp_path / "taylorgreen" / "config.json").read_text()
    assert '"wost_source": "net"' in cfg
