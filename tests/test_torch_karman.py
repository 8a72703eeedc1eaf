"""The karman family against the JAX package, on the CPU.

Module by module: the channel-and-circles geometry (analytic2d), the
scenes' obstacle SDF, fluid mask, inflow and hard boundary conditions,
obstacle-aware sampling, the 2 x 128 SIREN, then the chained karman step
(add_source, the halved ramp width, step) at tiny resolutions with the
full-width net. Inputs come from numpy seeds; the JAX side runs as its own
tests run it (the fused fit in Pallas interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (JaxKey, chained_runs, params_np, to_np)

from nmcfluid.geometry import analytic2d as j_geo
from nmcfluid.models.boundary import apply_boundary as j_apply_boundary
from nmcfluid.models.siren import (SirenConfig as JCfg, apply_siren as
                                   j_apply_siren, init_siren as j_init_siren)
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import NeuralFluid as JFluid
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.utils import checkpoint as j_ckpt

import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid_torch.geometry import analytic2d as t_geo
from nmcfluid_torch.models.boundary import apply_boundary as t_apply_boundary
from nmcfluid_torch.models.siren import (SirenConfig as TCfg, apply_siren as
                                         t_apply_siren, init_siren as
                                         t_init_siren, params_from_numpy)
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import sampling as t_sampling
from nmcfluid_torch.utils import checkpoint as t_ckpt

FAMILY = ["karman", "karman2cyl", "karman3cyl"]
GEOMETRY = ["karman", "karman3cyl"]


def _scenes(name):
    return j_get_scene(name), t_get_scene(name)


def _circles(name):
    return np.asarray(j_get_scene(name).boundary.circles, np.float64)


def _probe_points(name, n, seed):
    """Points over the channel and a margin around it, with a share on
    and near the circles, near the walls, in the inlet band and at the
    corners."""
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = j_get_scene(name).scene_size
    x = np.stack([rng.uniform(x0 - 0.1, x1 + 0.1, n),
                  rng.uniform(y0 - 0.1, y1 + 0.1, n)], -1)
    circ = _circles(name)
    k = n // 4
    c = circ[rng.integers(0, len(circ), k)]
    ang = rng.uniform(0, 2 * np.pi, k)
    rad = c[:, 2] + rng.uniform(-0.02, 0.05, k)
    rad[:k // 4] = c[:k // 4, 2]                   # on the circle
    x[:k] = c[:, :2] + rad[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    m = k + n // 8
    x[k:m, 1] = np.where(rng.random(m - k) < 0.5, y0, y1) \
        + rng.uniform(-0.03, 0.03, m - k)          # near the walls
    x[m:m + 20, 0] = x0 + rng.uniform(0.0, 0.007, 20)  # inlet band
    x[m + 20:m + 40, 0] = x0 + rng.uniform(0.0, 0.04, 20)
    x[m + 40:m + 44] = [[x0, y0], [x1, y0], [x0, y1], [x1, y1]]
    return x.astype(np.float32)


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("name", GEOMETRY)
@pytest.mark.parametrize("query", ["distance", "signed_distance",
                                   "star_radius"])
def test_channel_point_queries(name, query):
    """closest_point (distance and its sign) and star_radius on the
    channel with its circles and corner silhouette points: rtol 1e-6 /
    atol 1e-6."""
    jb, tb = j_get_scene(name).boundary, t_get_scene(name).boundary
    x = _probe_points(name, 4000, 1)
    if query == "star_radius":
        mx = np.random.default_rng(2).uniform(0, 3, x.shape[0]).astype(
            np.float32)
        want = j_geo.star_radius(jb, jnp.asarray(x), 1e-3, jnp.asarray(mx))
        got = t_geo.star_radius(tb, torch.from_numpy(x), 1e-3,
                                torch.from_numpy(mx))
    else:
        want = getattr(j_geo, query)(jb, jnp.asarray(x))
        got = getattr(t_geo, query)(tb, torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _rays(name, n, seed):
    """Origins in the channel; a third aimed at a circle's center (hits),
    a sixth out through the open inlet or outlet; random lengths."""
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = j_get_scene(name).scene_size
    o = np.stack([rng.uniform(x0 + 0.01, x1 - 0.01, n),
                  rng.uniform(y0 + 0.01, y1 - 0.01, n)], -1)
    phi = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(phi), np.sin(phi)], -1)
    circ = _circles(name)
    k = n // 3
    to_c = circ[rng.integers(0, len(circ), k), :2] - o[:k]
    d[:k] = to_c / np.linalg.norm(to_c, axis=-1, keepdims=True)
    m = k + n // 6
    side = rng.random(m - k) < 0.5
    o[k:m, 0] = np.where(side, x0 + 0.05, x1 - 0.05)
    d[k:m] = np.stack([np.where(side, -1.0, 1.0), 0.1 * rng.normal(
        size=m - k)], -1)
    d[k:m] /= np.linalg.norm(d[k:m], axis=-1, keepdims=True)
    tmax = rng.uniform(0.0, 3.0, n)
    return o.astype(np.float32), d.astype(np.float32), \
        tmax.astype(np.float32)


def _clear_rays(name, o, d, tmax):
    """Rays more than 1e-4 from tangency to every circle, from a grazing
    wall corner and from ending at the hit (float64): there a last-ulp
    difference may flip the hit flag."""
    o, d, tmax = (a.astype(np.float64) for a in (o, d, tmax))
    x0, x1, y0, y1 = j_get_scene(name).scene_size
    ok = np.ones(o.shape[0], bool)
    t_first = np.full(o.shape[0], np.inf)
    for cx, cy, r in _circles(name):
        oc = o - (cx, cy)
        b = np.sum(oc * d, -1)
        miss = np.sqrt(np.maximum(np.sum(oc * oc, -1) - b * b, 0.0))
        ok &= np.abs(miss - r) > 1e-4
        disc = b * b - (np.sum(oc * oc, -1) - r * r)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        t_first = np.where((disc > 0) & (t > 0), np.minimum(t_first, t),
                           t_first)
    for w in (y0, y1):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (w - o[:, 1]) / d[:, 1]
        xs = o[:, 0] + t * d[:, 0]
        ok &= ~((t > 0) & (np.minimum(np.abs(xs - x0), np.abs(xs - x1))
                           < 1e-4))
        t_first = np.where((t > 0) & (xs >= x0) & (xs <= x1),
                           np.minimum(t_first, t), t_first)
    return ok & (np.abs(t_first - tmax) > 1e-4)


@pytest.mark.parametrize("name", GEOMETRY)
def test_channel_ray_queries(name):
    """ray_intersect: equal hit flags on the clear rays (hits on circles
    and walls, escapes through the open sides), and t, point and normal
    at rtol 1e-6 / atol 1e-6; has_line_of_sight equal on the clear
    segments."""
    jb, tb = j_get_scene(name).boundary, t_get_scene(name).boundary
    o, d, tmax = _rays(name, 6000, 3)
    ok = _clear_rays(name, o, d, tmax)
    jh = j_geo.ray_intersect(jb, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tmax))
    th = t_geo.ray_intersect(tb, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tmax))
    hit_j, hit_t = np.asarray(jh[0]), to_np(th[0])
    np.testing.assert_array_equal(hit_t[ok], hit_j[ok])
    # the sample holds circle hits, wall hits and escapes through an open
    # side (no hit although the ray runs far enough to leave the box)
    on_circle = ok & hit_j & (np.abs(np.asarray(jh[3])).max(-1) < 0.999)
    assert on_circle.sum() > 500 and (ok & hit_j & ~on_circle).sum() > 500
    assert (ok & ~hit_j & (tmax > 2.5)).sum() > 100
    same = hit_t == hit_j
    for a, b in zip(th[1:], jh[1:]):
        np.testing.assert_allclose(to_np(a)[same], np.asarray(b)[same],
                                   rtol=1e-6, atol=1e-6)
    y = o + tmax[:, None] * d
    np.testing.assert_array_equal(
        to_np(t_geo.has_line_of_sight(tb, torch.from_numpy(o),
                                      torch.from_numpy(y)))[ok],
        np.asarray(j_geo.has_line_of_sight(jb, jnp.asarray(o),
                                           jnp.asarray(y)))[ok])


# ----------------------------------------------- scene functions and BCs

@pytest.mark.parametrize("name", FAMILY)
def test_obstacle_sdf_mask_and_source(name):
    """obstacle_sdf, fluid_mask and source_velocity: atol 1e-6."""
    js, ts = _scenes(name)
    x = _probe_points(name, 3000, 4)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(to_np(ts.obstacle_sdf(tx)),
                               np.asarray(js.obstacle_sdf(jx)), rtol=0,
                               atol=1e-6)
    mask = to_np(ts.fluid_mask(tx))
    np.testing.assert_array_equal(mask, np.asarray(js.fluid_mask(jx)))
    assert 0 < (~mask).sum() < mask.sum()
    np.testing.assert_allclose(to_np(ts.source_velocity(tx)),
                               np.asarray(js.source_velocity(jx)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", FAMILY)
@pytest.mark.parametrize("eps", [3e-2, 1.5e-2])
def test_boundary_and_velocity_affine(name, eps):
    """apply_boundary and the affine (A, c) form the fused fit takes, at
    the shipped ramp width and at its half, on points in the inlet band,
    near the obstacles and near the walls: atol 1e-6. In the inlet band
    c is the clamped inflow, nonzero."""
    js, ts = _scenes(name)
    x = _probe_points(name, 3000, 5)
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
    np.testing.assert_allclose(to_np(tA), np.asarray(jA), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=0, atol=1e-6)
    inlet = (x[:, 0] >= js.scene_size[0]) \
        & (x[:, 0] - js.scene_size[0] < eps / 2)
    inlet &= np.abs(x[:, 1] - js.scene_size[2]) > eps
    inlet &= np.abs(x[:, 1] - js.scene_size[3]) > eps
    assert inlet.sum() > 5
    np.testing.assert_array_equal(to_np(tc)[inlet, 0], js.karman_vel)


@pytest.mark.parametrize("name", GEOMETRY)
@pytest.mark.parametrize("rounds", [1, 2, 8])
def test_fluid_points_replay_jax_keys(name, rounds):
    """Obstacle rejection with the JAX-replay key: the same valid flags
    after 1, 2 and the default 8 rounds, and the same points to an ulp of
    the channel's coordinates (< 2 in magnitude: atol 2.4e-7). XLA fuses
    lo + u (hi - lo) into an FMA inside JAX's rejection loop, which moves
    a coordinate near zero by an ulp of the box's scale, far more than
    rtol 2e-7 of the coordinate."""
    js, ts = _scenes(name)
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


# ------------------------------------------------------------- 2 x 128 net

def test_siren_2x128_init_forward_and_checkpoint(tmp_path):
    """The karman net: init_siren replays JAX's draws exactly, the forward
    agrees at the SIREN tolerance (rtol 1e-4 / atol 2e-5), and a JAX
    checkpoint loads in the port and back unchanged."""
    jcfg, tcfg = JCfg(2, 2, 2, 128), TCfg(2, 2, 2, 128)
    params = j_init_siren(jax.random.PRNGKey(5), jcfg)
    for a, b in zip(params_np(t_init_siren(JaxKey.from_seed(5), tcfg)),
                    params_np(params)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(7)
    params = [(W, b + 0.05 * rng.normal(size=b.shape).astype(np.float32))
              for W, b in params]
    x = _probe_points("karman", 1000, 8)
    np.testing.assert_allclose(
        to_np(t_apply_siren(params_from_numpy(params), tcfg,
                            torch.from_numpy(x))),
        np.asarray(j_apply_siren(params, jcfg, jnp.asarray(x))), rtol=1e-4,
        atol=2e-5)
    j_ckpt.save_ckpt(str(tmp_path / "j"), params, 3)
    got, _ = t_ckpt.load_ckpt(str(tmp_path / "j"), params_from_numpy(params),
                              3)
    t_ckpt.save_ckpt(str(tmp_path / "t"), got, 4)
    back, _ = j_ckpt.load_ckpt(str(tmp_path / "t"), params, 4)
    for a, b in zip(params_np(back), params_np(params)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the chained step

TINY = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
            n_walks=48, max_n_iters=20, fit_pool=4)


@pytest.fixture(scope="module")
def karman_runs():
    return chained_runs("karman", TINY, halve_eps=True)


def test_karman_reset_weights_replay_jax(karman_runs):
    """Each phase fit of the step starts from fresh weights, drawn from
    the same keys as JAX's _phase_init: k1 of the step's split for the
    advection fit and fold_in(k_fit, 1) for the projection fit."""
    *_, logs = karman_runs
    assert len(logs["jax"]["init"]) == len(logs["torch"]["init"]) == 2
    for pj, pt in zip(logs["jax"]["init"], logs["torch"]["init"]):
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)


def _assert_fit_close(got, want):
    """A karman fit's params: the trunk at the karman-family fit tolerance
    (rtol 2e-4 / atol 2e-6, tests/test_fitkernel.py), the head's W at atol
    3e-5. The ls_head solve sets the head by a float32 eigensolve with a
    1e-5 relative cutoff, and the directions near the cutoff carry float32
    noise: on the same inputs the port's and JAX's solves land 5.3e-6
    apart in W, and the port's own lands 6.4e-6 from a float64 eigensolve
    (2e-5 in the velocity); along the chained step W differs by up to
    1.6e-5 while the trunk differs by at most 8.4e-7."""
    for i, (a, b) in enumerate(zip(got, want)):
        head_w = i == len(got) - 2
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=3e-5 if head_w else 2e-6)


def test_karman_each_fit_matches(karman_runs):
    """Params after the source, advection and projection fits
    (_assert_fit_close), and the same ls_head branches."""
    *_, logs = karman_runs
    names = [n for n, _ in logs["jax"]["fits"]]
    assert names == ["_fit_source", "_fit_advect", "_fit_project"]
    assert names == [n for n, _ in logs["torch"]["fits"]]
    for (_, pj), (_, pt) in zip(logs["jax"]["fits"], logs["torch"]["fits"]):
        _assert_fit_close(pt, pj)
    assert len(logs["jax"]["branch"]) == 3
    assert logs["torch"]["branch"] == logs["jax"]["branch"]


def test_karman_projection_stages_match(karman_runs):
    """On the JAX run's own stage inputs (its advection fit's params, its
    divergence grid and chunk key): the divergence grid on the non-square
    (16, 6) karman grid at test_torch_step.py's rtol 1e-4 / atol 5e-5; the
    same pressure cloud to an ulp of the coordinates, equal valid flags,
    and p / grad p at the gen-vs-pool tolerances of tests/test_gen.py."""
    jf, js, tf, ts, logs = karman_runs
    prev = params_from_numpy(list(zip(*[iter(logs["jax"]["fits"][1][1])]
                                      * 2)))
    got = tfluid._divergence_grid(tf, prev, ts.eps, 1)
    assert got.shape == tf._last_projection[3].shape == (16, 6)
    np.testing.assert_allclose(to_np(got), np.asarray(jf._last_projection[3]),
                               rtol=1e-4, atol=5e-5)
    assert len(logs["jax"]["pressure"]) == 1
    grid, key, (pts_j, valid_j, p_j, g_j) = logs["jax"]["pressure"][0]
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve(
        tf, (torch.from_numpy(grid),), JaxKey(key))
    np.testing.assert_allclose(to_np(pts_t), pts_j, rtol=0,
                               atol=float(np.spacing(np.float32(2.0))))
    np.testing.assert_array_equal(to_np(valid_t), valid_j)
    np.testing.assert_allclose(to_np(p_t), p_j, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(to_np(g_t), g_j, rtol=2e-3, atol=2e-4)


def test_karman_final_state(karman_runs):
    """The halved ramp width, the step count and the params after the
    step (_assert_fit_close)."""
    jf, js, tf, ts, _ = karman_runs
    assert ts.timestep == int(js.timestep) == 1
    assert np.float32(ts.eps) == np.asarray(js.eps) == np.float32(1.5e-2)
    assert np.isfinite(float(ts.P)) and np.isfinite(
        float(tf.kinetic_energy(ts)))
    _assert_fit_close(params_np(ts.params), params_np(js.params))
