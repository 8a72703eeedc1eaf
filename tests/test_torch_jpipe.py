"""The jpipe scene against the JAX package, on the CPU.

Module by module: the J-pipe's wall distance, interior mask and inflow,
its hard boundary conditions with the affine (A, c) form the fused fit
takes (off-diagonal A in the elbow), the rejection sampler with the
JAX-replay key, the gen walk on the segment soup (walks leave through the
open inlet and outlet), then the chained jpipe step (add_source, step) and
both command lines, at tiny resolutions with the full-width 2 x 128 net.
Inputs come from numpy seeds; the JAX side runs as its own tests run it
(the fused fit in Pallas interpret mode; the CLI on its fresh-batch fit).
Tolerances are the karman family's (tests/test_torch_karman.py), the net
sharing its width and its fits, but for two effects of the soup and the
elbow, measured and stated where they apply: walks that diverge on the
walls (_walk_close) and the head solve's float32 noise
(_assert_fit_close).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (JaxKey, capture_frames, chained_runs,
                           ckpt_leaves, cli_pair, params_np,
                           replay_key_seam, to_np, tree_files)
from _torch_parity import spread as _spread
from _torch_parity import walk_close as _walk_close

import nmcfluid.replay as jreplay
import nmcfluid.utils.vis as jvis
from nmcfluid.models.boundary import apply_boundary as j_apply_boundary
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import NeuralFluid as JFluid
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.wost import WalkSettings as JSettings, WostScene as JScene
from nmcfluid.wost.gen import estimate_solution_and_gradient_gen as j_gen

import nmcfluid_torch.replay as treplay
import nmcfluid_torch.sim.fluid as tfluid
import nmcfluid_torch.utils.vis as tvis
from nmcfluid_torch.models.boundary import apply_boundary as t_apply_boundary
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import sampling as t_sampling
from nmcfluid_torch.wost.gen import estimate_solution_and_gradient_gen \
    as t_gen
from nmcfluid_torch.wost.solver import (WalkSettings as TSettings,
                                        WostScene as TScene)


def _scenes():
    return j_get_scene("jpipe"), t_get_scene("jpipe")


def _probe_points(n, seed):
    """Points over [-0.1, 2.1]^2, with shares in the elbow (x > 1, y < 1,
    between the radii), near the walls, in the inlet band and on the
    arms' edges."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 2.1, (n, 2))
    k = n // 4
    ang = rng.uniform(0.0, 0.5 * np.pi, k)
    rad = rng.uniform(0.45, 1.05, k)
    x[:k] = np.stack([1.0 + rad * np.sin(ang), 1.0 - rad * np.cos(ang)], -1)
    m = k + n // 8
    x[k:m] = np.stack([rng.uniform(0.0, 1.0, m - k),
                       np.where(rng.random(m - k) < 0.5, 0.0, 0.5)
                       + rng.uniform(-0.04, 0.04, m - k)], -1)
    x[m:m + 40] = np.stack([rng.uniform(0.0, 0.1, 40),
                            rng.uniform(0.0, 0.5, 40)], -1)  # inlet band
    x[m + 40:m + 48] = [[0.0, 0.0], [1.0, 0.25], [1.0, 0.5], [1.5, 1.0],
                        [2.0, 1.0], [1.75, 2.0], [0.1, 0.25], [1.4, 0.3]]
    return x.astype(np.float32)


def _elbow(x):
    return (x[:, 0] > 1.0) & (x[:, 1] < 1.0)


def test_sdf_mask_and_source():
    """obstacle_sdf (the unsigned wall distance), fluid_mask (the pipe's
    interior) and source_velocity: atol 1e-6, masks equal."""
    js, ts = _scenes()
    x = _probe_points(3000, 4)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(to_np(ts.obstacle_sdf(tx)),
                               np.asarray(js.obstacle_sdf(jx)), rtol=0,
                               atol=1e-6)
    mask = to_np(ts.fluid_mask(tx))
    np.testing.assert_array_equal(mask, np.asarray(js.fluid_mask(jx)))
    assert mask.sum() > 500 and (~mask).sum() > 500
    src = to_np(ts.source_velocity(tx))
    np.testing.assert_allclose(src, np.asarray(js.source_velocity(jx)),
                               rtol=0, atol=1e-6)
    assert np.all(src[~mask] == 0.0) and np.any(src[mask, 0] == 0.5)


@pytest.mark.parametrize("eps", [3e-2, 1e-2])
def test_boundary_and_velocity_affine(eps):
    """apply_boundary and the affine (A, c) form at the shipped ramp width
    and a narrower one: atol 1e-6. In the elbow A is the projection that
    scales the radial component about (1, 1) by the wall distance, so its
    off-diagonal entries are nonzero; in the inlet band c is the clamped
    inflow; outside the pipe both vanish."""
    js, ts = _scenes()
    x = _probe_points(3000, 5)
    raw = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = j_apply_boundary(js, jnp.asarray(raw), jx, eps=jnp.float32(eps))
    got = t_apply_boundary(ts, torch.from_numpy(raw), tx, eps=eps)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)
    sizes = dict(sample_resolution=8, wost_resolution=8, div_resolution=8)
    jA, jc = JFluid(js, **sizes).velocity_affine(jx, eps=jnp.float32(eps),
                                                 t=1)
    tA, tc = tfluid.NeuralFluid(ts, device="cpu", **sizes).velocity_affine(
        tx, eps=eps, t=1)
    tA, tc = to_np(tA), to_np(tc)
    np.testing.assert_allclose(tA, np.asarray(jA), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=0, atol=1e-6)
    inside = to_np(ts.fluid_mask(tx))
    corner = _elbow(x) & inside
    assert (np.abs(tA[corner, 0, 1]) > 1e-2).sum() > 100
    assert np.all(tA[~corner, 0, 1] == 0.0)
    inlet = (x[:, 0] >= 0) & (x[:, 0] <= 0.1) & (x[:, 1] > eps) \
        & (x[:, 1] < 0.5 - eps)
    assert inlet.sum() > 5
    np.testing.assert_array_equal(tc[inlet, 0], js.karman_vel)
    assert np.all(tA[~inside] == 0.0) and np.all(tc[~inside] == 0.0)


@pytest.mark.parametrize("rounds", [1, 2, 8])
def test_fluid_points_replay_jax_keys(rounds):
    """The J-pipe's rejection sampler with the JAX-replay key: the same
    valid flags after 1, 2 and the default 8 rounds and the same points
    to an ulp of the box's scale (atol 2.4e-7, as for karman); so do the
    training points."""
    js, ts = _scenes()
    ulp = float(np.spacing(np.float32(2.0)))
    k = jax.random.PRNGKey(21)
    jp, jv = j_sampling.fluid_points(k, 5000, js, rounds=rounds)
    tp, tv = t_sampling.fluid_points(JaxKey(k), 5000, ts, rounds=rounds)
    np.testing.assert_allclose(to_np(tp), np.asarray(jp), rtol=0, atol=ulp)
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
    if rounds == 1:
        assert not to_np(tv).all()
    tp2, tv2 = t_sampling.training_points(JaxKey(k), 5000, ts)
    jp2, jv2 = j_sampling.training_points(k, 5000, js)
    np.testing.assert_allclose(to_np(tp2), np.asarray(jp2), rtol=0, atol=ulp)
    np.testing.assert_array_equal(to_np(tv2), np.asarray(jv2))


def test_gen_walk_on_the_soup_matches_jax_gen():
    """The gen walk on the J-pipe soup, sigma = 350, nearest-texel source
    from a random 200^2 grid, at 40 points (the inlet and outlet, the
    elbow's reflex vertices, the walls) with 48 walks and the JAX-replay
    key: the same valid counts (walks that leave through the open ends
    drop out), and p and grad p at the gen-vs-pool tolerances of
    tests/test_gen.py (rtol 2e-4 / atol 2e-5, rtol 2e-3 / atol 2e-4) on
    nine points in ten, the rest within the walk's own noise
    (_walk_close)."""
    js, ts = _scenes()
    rng = np.random.default_rng(0)
    pts, _ = t_sampling.fluid_points(JaxKey(jax.random.PRNGKey(9)), 40, ts)
    pts = to_np(pts)
    pts[:8] = [[0.01, 0.25], [0.002, 0.1], [1.75, 1.99], [1.6, 1.995],
               [1.0 + 0.52 * np.sin(0.3), 1.0 - 0.52 * np.cos(0.3)],
               [1.0 + 0.51 * np.sin(1.0), 1.0 - 0.51 * np.cos(1.0)],
               [0.5, 0.003], [1.997, 1.5]]
    grid = rng.normal(size=(200, 200)).astype(np.float32)
    ss = js.scene_size
    jsc = JScene(dim=2, neumann=js.boundary,
                 source_fn=lambda y, g: j_sampling.nearest_lookup(g, ss, y),
                 absorption=350.0)
    tsc = TScene(dim=2, neumann=ts.boundary,
                 source_fn=lambda y, g: t_sampling.nearest_lookup(g, ss, y),
                 absorption=350.0)

    def jax_walk(key):
        return j_gen(jsc, JSettings(algo="gen"), jnp.asarray(pts), key, 48,
                     source_args=(jnp.asarray(grid),))
    key = jax.random.PRNGKey(3)
    p_j, g_j, n_j = jax_walk(key)
    p_j2, g_j2, _ = jax_walk(jax.random.PRNGKey(4))
    p_t, g_t, n_t = t_gen(tsc, TSettings(algo="gen"), torch.from_numpy(pts),
                          JaxKey(key), 48, source_args=(
                              torch.from_numpy(grid),))
    np.testing.assert_array_equal(to_np(n_t), np.asarray(n_j))
    assert (to_np(n_t)[:4] < 48).sum() >= 2          # escapes at the ends
    _walk_close(to_np(p_t), p_j, _spread(p_j, p_j2), 2e-4, 2e-5)
    _walk_close(to_np(g_t), g_j, _spread(g_j, g_j2), 2e-3, 2e-4)


def test_pressure_mask_on_the_soup():
    """_mask_pressure on the soup: p zeroed within boundary_distance_mask
    of a wall, grad p also outside the pipe, as the JAX package's
    (distance and sign from the soup's closest point)."""
    import nmcfluid.sim.fluid as jfluid
    js, ts = _scenes()
    x = _probe_points(2000, 7)
    x[:50] = np.stack([np.linspace(0.2, 0.8, 50),      # next to y = 0
                       0.0002 + 0.0006 * np.arange(50) / 50], -1)
    rng = np.random.default_rng(8)
    p = rng.normal(size=x.shape[0]).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    valid = np.asarray(js.fluid_mask(jnp.asarray(x)))
    sizes = dict(sample_resolution=8, wost_resolution=8, div_resolution=8)
    jf = JFluid(js, **sizes)
    tf = tfluid.NeuralFluid(ts, device="cpu", **sizes)
    want = jfluid._mask_pressure(jf, jnp.asarray(x), jnp.asarray(valid),
                                 jnp.asarray(p), jnp.asarray(g))
    got = tfluid._mask_pressure(tf, torch.from_numpy(x),
                                torch.from_numpy(valid), torch.from_numpy(p),
                                torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    assert (to_np(got[0])[:50] == 0).all()


# ------------------------------------------------------ the chained step

TINY = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
            n_walks=48, max_n_iters=20, fit_pool=4)


@pytest.fixture(scope="module")
def jpipe_runs():
    """chained_runs on jpipe, keeping the JAX projection fit's inputs."""
    import nmcfluid.sim.fluid as jfluid
    inputs = []
    fit = jfluid._fit_project

    def keep(*a, **kw):
        inputs.append(a)
        return fit(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfluid, "_fit_project", keep)
        runs = chained_runs("jpipe", TINY)
    return runs + (inputs,)


def _assert_fit_close(got, want, trunk=2e-6, head=1e-4):
    """A fit's params: the trunk at the karman family's rtol 2e-4 / atol
    2e-6, the head (W and b) at atol 1e-4. The ls_head solve sets the head
    by a float32 eigensolve with a 1e-5 relative cutoff: on the jpipe
    projection fit's own inputs the port's solve lands 2.2e-4 from the
    same solve with a float64 eigensolve, and 4.0e-5 from JAX's (karman:
    6.4e-6 and 5.3e-6, tests/test_torch_karman.py), since the elbow's
    off-diagonal A couples the two outputs in the normal matrix."""
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=head if i >= len(got) - 2 else trunk)


def test_jpipe_each_fit_matches(jpipe_runs):
    """Fresh weights for each phase fit from JAX's keys; the source and
    advection fits' params; the projection fit run by the port on the JAX
    run's own inputs (its advection fit, pressure cloud, grad p and key),
    against the JAX run's projection fit; the ls_head branches of the
    source and advection fits; the ramp width kept after add_source. The
    two runs' own projection fits differ by the walks _walk_close allows
    (test_jpipe_final_state)."""
    jf, js, tf, ts, logs, inputs = jpipe_runs
    for pj, pt in zip(logs["jax"]["init"], logs["torch"]["init"]):
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)
    names = [n for n, _ in logs["jax"]["fits"]]
    assert names == ["_fit_source", "_fit_advect", "_fit_project"]
    assert names == [n for n, _ in logs["torch"]["fits"]]
    for (_, pj), (_, pt) in list(zip(logs["jax"]["fits"],
                                     logs["torch"]["fits"]))[:2]:
        _assert_fit_close(pt, pj)
    assert logs["torch"]["branch"][:2] == logs["jax"]["branch"][:2]
    assert np.float32(ts.eps) == np.asarray(js.eps) == np.float32(3e-2)
    from nmcfluid_torch.models.siren import params_from_numpy
    _, p0, prev, pts, grad_p, key, eps, t = inputs[0]

    def port(p):
        return params_from_numpy([(np.asarray(W), np.asarray(b))
                                  for W, b in p])
    got, _ = tfluid._fit_project(tf, port(p0), port(prev),
                                 torch.from_numpy(np.asarray(pts)),
                                 torch.from_numpy(np.asarray(grad_p)),
                                 JaxKey(key), float(eps), int(t))
    _assert_fit_close(params_np(got), logs["jax"]["fits"][2][1])


def test_jpipe_projection_stages_match(jpipe_runs):
    """On the JAX run's own stage inputs: the divergence grid at rtol 1e-4
    / atol 5e-5 (tests/test_torch_step.py), the pressure cloud to an ulp
    of the box and equal valid flags; p and grad p at the gen tolerances
    on nine points in ten and within the walk's noise elsewhere
    (_walk_close; the spread is JAX's own between two chunk keys)."""
    jf, js, tf, ts, logs, _ = jpipe_runs
    from nmcfluid_torch.models.siren import params_from_numpy
    import nmcfluid.sim.fluid as jfluid
    prev = params_from_numpy(list(zip(*[iter(logs["jax"]["fits"][1][1])]
                                      * 2)))
    got = tfluid._divergence_grid(tf, prev, ts.eps, 1)
    np.testing.assert_allclose(to_np(got), np.asarray(jf._last_projection[3]),
                               rtol=1e-4, atol=5e-5)
    grid, key, (pts_j, valid_j, p_j, g_j) = logs["jax"]["pressure"][0]
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve(
        tf, (torch.from_numpy(grid),), JaxKey(key))
    np.testing.assert_allclose(to_np(pts_t), pts_j, rtol=0,
                               atol=float(np.spacing(np.float32(2.0))))
    np.testing.assert_array_equal(to_np(valid_t), valid_j)
    # the same cloud walked on another key: JAX's own spread
    pj2, gj2, _ = j_gen(jf._wost_scene, jf.walk_settings,
                        jnp.asarray(pts_j), jax.random.PRNGKey(77),
                        source_args=(jnp.asarray(grid),))
    m_p, m_g = jfluid._mask_pressure(jf, jnp.asarray(pts_j),
                                     jnp.asarray(valid_j), pj2, gj2)
    _walk_close(to_np(p_t), p_j, _spread(p_j, m_p), 2e-4, 2e-5)
    _walk_close(to_np(g_t), g_j, _spread(g_j, m_g), 2e-3, 2e-4)


def _assert_step_close(got, want, fluid, eps, t):
    """The params after a step whose projection fit saw each run's own
    walk, whose few diverging walks move about one grad p in twenty by up
    to its noise (test_jpipe_projection_stages_match): the trunk at rtol
    2e-4 / atol 1e-4 (measured up to 5.2e-5 in the chained step, 4.4e-5
    through the CLI), and, since the head solve turns those targets into
    head changes of up to 1.6e-3, the velocity itself: its RMS difference
    inside the pipe on a 200^2 grid at most 1e-2 of its RMS (measured
    3.1e-3, while the step moves it by 0.43)."""
    from nmcfluid_torch.models.siren import params_from_numpy
    for a, b in list(zip(got, want))[:-2]:
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-4)
    g = t_sampling.uniform_grid(fluid.scene.scene_size, 200)
    inside = fluid.scene.fluid_mask(g)

    def vel(leaves):
        p = params_from_numpy(list(zip(leaves[0::2], leaves[1::2])))
        return fluid.velocity(p, g, eps=eps, t=t)[inside]
    ug, uw = vel(got), vel(want)
    rel = float((ug - uw).pow(2).mean().sqrt() / uw.pow(2).mean().sqrt())
    assert rel <= 1e-2, rel


def test_jpipe_final_state(jpipe_runs):
    """One step, the ramp width kept, a finite mean pressure, and the
    params after the step (_assert_step_close); the same projection fit
    on equal inputs holds at _assert_fit_close's tolerance
    (test_jpipe_each_fit_matches)."""
    jf, js, tf, ts, _, _ = jpipe_runs
    assert ts.timestep == int(js.timestep) == 1
    assert np.isfinite(float(ts.P))
    _assert_step_close(params_np(ts.params), params_np(js.params), tf,
                       ts.eps, 1)


# ------------------------------------------------------ the command lines

@pytest.fixture(scope="module")
def jpipe_cli(tmp_path_factory):
    return cli_pair(tmp_path_factory.mktemp("jpipe"), "jpipe", [])


def test_cli_checkpoints_match_jax(jpipe_cli):
    """python -m nmcfluid_torch.run jpipe --device cpu at tiny size
    against the JAX CLI (both on the fresh-batch fit): the same files,
    the checkpoint after add_source at _assert_fit_close's tolerance and
    the one after the step by _assert_step_close."""
    jdir, tdir, _ = jpipe_cli
    assert tree_files(tdir) == tree_files(jdir)
    ckpts = []
    for t in (0, 1):
        name = f"model/ckpt_step_t{t:03d}.npz"
        (lj, tj), (lt, tt) = ckpt_leaves(jdir / name), ckpt_leaves(
            tdir / name)
        assert tj == tt == t
        ckpts.append((lt, lj))
    _assert_fit_close(*ckpts[0])
    scene = t_get_scene("jpipe")
    fluid = tfluid.NeuralFluid(scene, device="cpu", sample_resolution=8,
                               wost_resolution=8, div_resolution=8)
    _assert_step_close(*ckpts[1], fluid, scene.bdry_eps, 1)


def test_replay_vorticity_on_jax_checkpoints(jpipe_cli, tmp_path):
    """replay vorticity of the JAX CLI's jpipe checkpoints in both
    packages: the same frames, at the derivatives' rtol 1e-4 / atol 5e-5
    (tests/test_torch_transport.py)."""
    jdir, _, _ = jpipe_cli
    exp = tmp_path / "jpipe"
    shutil.copytree(jdir / "model", exp / "model")
    frames = {"jax": {}, "torch": {}}
    with pytest.MonkeyPatch.context() as mp:
        replay_key_seam(mp)
        capture_frames(mp, jvis, frames["jax"])
        capture_frames(mp, tvis, frames["torch"])
        args = ["jpipe", "vorticity", "--exp", str(exp), "--resolution",
                "16"]
        jreplay.main(args)
        treplay.main(args + ["--device", "cpu"])
    assert sorted(frames["torch"]) == sorted(frames["jax"]) == [
        "vorticity_t000.png", "vorticity_t001.png"]
    for k, v in frames["jax"].items():
        np.testing.assert_allclose(frames["torch"][k], v, rtol=1e-4,
                                   atol=5e-5)
