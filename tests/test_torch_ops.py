"""Parity of the port's leaf modules with the JAX package, on the CPU.

Every input is made with numpy from a seed and handed to both packages.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, params_np, to_np

from nmcfluid.geometry import analytic2d as j_geo
from nmcfluid.models.boundary import apply_boundary as j_apply_boundary
from nmcfluid.models.siren import (SirenConfig as JCfg, apply_siren as
                                   j_apply_siren, apply_siren_features as
                                   j_features, init_siren as j_init_siren)
from nmcfluid.ops import bessel as j_bessel
from nmcfluid.ops import fastrand as j_fastrand
from nmcfluid.ops import greens2d as j_greens
from nmcfluid.ops import radial_tables as j_rt
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.utils import checkpoint as j_ckpt

from nmcfluid_torch.geometry import analytic2d as t_geo
from nmcfluid_torch.models.boundary import apply_boundary as t_apply_boundary
from nmcfluid_torch.models.siren import (SirenConfig as TCfg, apply_siren as
                                         t_apply_siren, apply_siren_features
                                         as t_features, init_siren as
                                         t_init_siren, params_from_numpy)
from nmcfluid_torch.ops import bessel as t_bessel
from nmcfluid_torch.ops import fastrand as t_fastrand
from nmcfluid_torch.ops import greens2d as t_greens
from nmcfluid_torch.ops import radial_tables as t_rt
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import sampling as t_sampling
from nmcfluid_torch.utils import checkpoint as t_ckpt

TG_LO, TG_HI = 0.000447, 6.279553


# ------------------------------------------------------------- fastrand

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fastrand_uniform_bit_exact(seed):
    """PCG emulated in int64 must give JAX's uint32 PCG bit for bit, over
    random seeds, steps, salts and lanes, lanes near 2^32 included."""
    rng = np.random.default_rng(seed)
    lanes = np.concatenate([
        rng.integers(0, 2 ** 32, 3000, dtype=np.uint64),
        2 ** 32 - 1 - np.arange(50, dtype=np.uint64),
        np.arange(50, dtype=np.uint64)]).astype(np.uint32)
    steps = rng.integers(0, 2 ** 32, lanes.shape[0], dtype=np.uint64) \
        .astype(np.uint32)
    for _ in range(4):
        s = int(rng.integers(0, 2 ** 32))
        salt = int(rng.integers(0, 64))
        want = j_fastrand.uniform(jnp.uint32(s), jnp.asarray(steps), salt,
                                  jnp.asarray(lanes))
        got = t_fastrand.uniform(s, torch.from_numpy(steps.astype(np.int64)),
                                 salt, torch.from_numpy(lanes.astype(np.int64)))
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
        # scalar step, as the JAX package's lockstep walk passes it
        st = int(rng.integers(0, 2 ** 32))
        want = j_fastrand.uniform(jnp.uint32(s), st, salt, jnp.asarray(lanes))
        got = t_fastrand.uniform(s, st, salt,
                                 torch.from_numpy(lanes.astype(np.int64)))
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_stream_seed_matches_seed_from_key():
    for s in range(20):
        k = jax.random.fold_in(jax.random.PRNGKey(s), 0xC0FFEE + s)
        assert JaxKey(k).stream_seed() == int(j_fastrand.seed_from_key(k))


# --------------------------------------------------------------- bessel

@pytest.mark.parametrize("fn", ["k0e", "k1e", "i0e", "i1e"])
def test_scaled_bessel(fn):
    """Same A&S polynomials on both sides (i0e/i1e from each library):
    rtol 1e-5 is a few f32 ulps of the polynomial evaluation."""
    x = np.geomspace(1e-4, 4e3, 2001).astype(np.float32)
    want = np.asarray(getattr(j_bessel, fn)(jnp.asarray(x)))
    got = to_np(getattr(t_bessel, fn)(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# --------------------------------------------------------------- greens

@pytest.fixture(scope="module")
def yukawa():
    return j_greens.Yukawa2D(350.0), t_greens.Yukawa2D(350.0)


@pytest.mark.parametrize("method", ["eval", "dspk", "grad_norm_over_eval",
                                    "norm", "pk_over_uniform",
                                    "pk_grad_over_thr"])
def test_yukawa2d(yukawa, method):
    """Elementwise ball quantities at sigma = 350 over radii from 1e-4 to
    the scene size: rtol 1e-5 (f32 rounding of the same formulas). The
    sample radius stays below 0.9 R: G(r) is a difference of two terms
    that cancel as r -> R, where one ulp of either term is no longer
    small against the result."""
    jg, tg = yukawa
    rng = np.random.default_rng(4)
    R = np.exp(rng.uniform(np.log(1e-3), np.log(3.0), 4000)).astype(np.float32)
    r = (R * rng.uniform(0.0, 0.9, R.shape)).astype(np.float32)
    jb = jg.make_ball(jnp.asarray(R))
    tb = tg.make_ball(torch.from_numpy(R))
    if method in ("norm", "pk_over_uniform", "pk_grad_over_thr"):
        want, got = getattr(jg, method)(jb), getattr(tg, method)(tb)
    else:
        want = getattr(jg, method)(jb, jnp.asarray(np.maximum(r, 1e-4)))
        got = getattr(tg, method)(tb, torch.from_numpy(np.maximum(r, 1e-4)))
    # norm = (1 - e^{-Z}/i0e(Z))/sigma cancels at small Z: allow 8 f32
    # ulps of the 1 before the division by sigma
    atol = 8 * 2.0 ** -23 / 350.0 if method == "norm" else 1e-30
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=atol)


def test_radial_table_and_draw(yukawa):
    """The copied float64 table is identical; the port's gather draw
    matches the JAX package's gather draw to 1e-6 and its one-hot matmul
    form (the one its walk uses) to about an ulp."""
    np.testing.assert_array_equal(t_rt.build_table(2), j_rt.build_table(2))
    rng = np.random.default_rng(5)
    Z = np.exp(rng.uniform(np.log(1e-4), np.log(1e4), 5000)).astype(
        np.float32)
    u = rng.uniform(0.0, 1.0, Z.shape).astype(np.float32)
    quads = j_rt.pack_quads(j_rt.build_table(2)).astype(np.float32)
    want = np.asarray(j_rt.sample_t_screened_u(quads, jnp.asarray(Z),
                                               jnp.asarray(u)))
    got = to_np(t_rt.sample_t_screened_u(torch.from_numpy(quads),
                                         torch.from_numpy(Z),
                                         torch.from_numpy(u)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want_mm = np.asarray(j_rt.sample_t_screened_u_mm(
        j_rt.build_table(2).astype(np.float32), jnp.asarray(Z),
        jnp.asarray(u)))
    np.testing.assert_allclose(got, want_mm, rtol=0, atol=1e-6)
    # and through Yukawa2D.sample_radius_u on the same uniforms
    jg, tg = yukawa
    R = (Z / math.sqrt(350.0)).astype(np.float32)
    u2 = np.stack([u, u[::-1]], -1)
    rj, gj = jg.sample_radius_u(jg.make_ball(jnp.asarray(R)),
                                jnp.asarray(u2))
    rt, gt = tg.sample_radius_u(tg.make_ball(torch.from_numpy(R)),
                                torch.from_numpy(u2))
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=1e-5,
                               atol=1e-7)
    inner = to_np(rt) < 0.9 * R          # G cancels as r -> R (see above)
    np.testing.assert_allclose(to_np(gt)[inner], np.asarray(gj)[inner],
                               rtol=1e-4, atol=1e-30)


# ---------------------------------------------------------- box queries

def _box():
    return (j_geo.make_analytic2d((TG_LO, TG_LO), (TG_HI, TG_HI)),
            t_geo.make_analytic2d((TG_LO, TG_LO), (TG_HI, TG_HI)))


def _pts(seed, n=3000):
    rng = np.random.default_rng(seed)
    # mostly inside, some outside and some on the walls
    x = rng.uniform(-0.5, 6.8, (n, 2)).astype(np.float32)
    x[:20, 0] = TG_LO
    x[20:40, 1] = TG_HI
    return x


@pytest.mark.parametrize("query", ["distance", "signed_distance",
                                   "dist_to_far_bbox_corner",
                                   "outside_bbox", "star_radius"])
def test_box_point_queries(query):
    jb, tb = _box()
    x = _pts(6)
    if query == "star_radius":
        mx = np.random.default_rng(7).uniform(0, 3, x.shape[0]).astype(
            np.float32)
        want = j_geo.star_radius(jb, jnp.asarray(x), 1e-3, jnp.asarray(mx))
        got = t_geo.star_radius(tb, torch.from_numpy(x), 1e-3,
                                torch.from_numpy(mx))
    else:
        want = getattr(j_geo, query)(jb, jnp.asarray(x))
        got = getattr(t_geo, query)(tb, torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_box_ray_queries():
    jb, tb = _box()
    rng = np.random.default_rng(8)
    o = rng.uniform(0.1, 6.1, (4000, 2)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, 4000)
    d = np.stack([np.cos(phi), np.sin(phi)], -1).astype(np.float32)
    d[:10] = [1.0, 0.0]                      # axis-aligned rays
    tmax = rng.uniform(0.0, 4.0, 4000).astype(np.float32)
    jh = j_geo.ray_intersect(jb, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tmax))
    th = t_geo.ray_intersect(tb, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tmax))
    np.testing.assert_array_equal(to_np(th[0]), np.asarray(jh[0]))
    for a, b in zip(th[1:], jh[1:]):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    y = rng.uniform(-0.5, 6.8, (4000, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(t_geo.has_line_of_sight(tb, torch.from_numpy(o),
                                      torch.from_numpy(y))),
        np.asarray(j_geo.has_line_of_sight(jb, jnp.asarray(o),
                                           jnp.asarray(y))))


# --------------------------------------------------- sampling / lookup

def test_uniform_grid_and_nearest_lookup():
    ss = (TG_LO, TG_HI, TG_LO, TG_HI)
    for res, wb in ((16, False), (37, True)):
        np.testing.assert_allclose(
            to_np(t_sampling.uniform_grid(ss, res, wb)),
            np.asarray(j_sampling.uniform_grid(ss, res, wb)), rtol=1e-6)
    rng = np.random.default_rng(9)
    grid = rng.normal(size=(40, 40)).astype(np.float32)
    y = rng.uniform(-1.0, 7.5, (5000, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(t_sampling.nearest_lookup(torch.from_numpy(grid), ss,
                                        torch.from_numpy(y))),
        np.asarray(j_sampling.nearest_lookup(jnp.asarray(grid), ss,
                                             jnp.asarray(y))))


def test_training_points_replay_jax_keys():
    jscene, tscene = j_get_scene("taylorgreen"), t_get_scene("taylorgreen")
    k = jax.random.PRNGKey(12)
    jp, jv = j_sampling.training_points(k, 333, jscene)
    tp, tv = t_sampling.training_points(JaxKey(k), 333, tscene)
    np.testing.assert_array_equal(to_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))


# ---------------------------------------------------------------- SIREN

def _siren_problem(seed, Lh=3, H=32):
    jcfg = JCfg(2, 2, num_hidden_layers=Lh, hidden_features=H)
    tcfg = TCfg(2, 2, num_hidden_layers=Lh, hidden_features=H)
    params = j_init_siren(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # trained-looking biases, so the bias path is exercised too
    params = [(W, b + 0.05 * rng.normal(size=b.shape).astype(np.float32))
              for W, b in params]
    x = rng.uniform(TG_LO, TG_HI, (700, 2)).astype(np.float32)
    return jcfg, tcfg, params, x


def test_init_siren_replays_jax():
    jcfg = JCfg(2, 2, num_hidden_layers=6, hidden_features=64)
    tcfg = TCfg(2, 2, num_hidden_layers=6, hidden_features=64)
    want = j_init_siren(jax.random.PRNGKey(3), jcfg)
    got = t_init_siren(JaxKey.from_seed(3), tcfg)
    for a, b in zip(params_np(got), params_np(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["apply_siren", "apply_siren_features"])
def test_siren_forward(fn):
    """f32 matmuls on both sides (the JAX CPU dot is f32): the sin(30 z)
    layers amplify the reassociation to ~1e-5 absolute."""
    jcfg, tcfg, params, x = _siren_problem(0)
    jf = j_apply_siren if fn == "apply_siren" else j_features
    tf = t_apply_siren if fn == "apply_siren" else t_features
    want = np.asarray(jf(params, jcfg, jnp.asarray(x)))
    got = to_np(tf(params_from_numpy(params), tcfg, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_tg_boundary_and_velocity_affine():
    from nmcfluid.sim import NeuralFluid as JFluid
    from nmcfluid_torch.sim.fluid import NeuralFluid as TFluid
    jscene, tscene = j_get_scene("taylorgreen"), t_get_scene("taylorgreen")
    rng = np.random.default_rng(10)
    x = rng.uniform(TG_LO, TG_HI, (2000, 2)).astype(np.float32)
    x[:200] = TG_LO + rng.uniform(0, 2e-3, (200, 2))   # inside the ramp
    raw = rng.normal(size=(2000, 2)).astype(np.float32)
    eps = 1e-3
    want = j_apply_boundary(jscene, jnp.asarray(raw), jnp.asarray(x),
                            eps=jnp.float32(eps))
    got = t_apply_boundary(tscene, torch.from_numpy(raw), torch.from_numpy(x),
                           eps=eps)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    jf = JFluid(jscene, sample_resolution=8, wost_resolution=8,
                div_resolution=8)
    tf = TFluid(tscene, sample_resolution=8, wost_resolution=8,
                div_resolution=8, device="cpu")
    jA, jc = jf.velocity_affine(jnp.asarray(x), eps=jnp.float32(eps), t=1)
    tA, tc = tf.velocity_affine(torch.from_numpy(x), eps=eps, t=1)
    np.testing.assert_allclose(to_np(tA), np.asarray(jA), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), atol=1e-7)


def test_checkpoint_crosses_packages(tmp_path):
    """A checkpoint written by the JAX package loads in the port, and one
    written by the port loads in the JAX package."""
    jcfg, tcfg, params, _ = _siren_problem(1)
    j_ckpt.save_ckpt(str(tmp_path / "j"), params, 7)
    like = params_from_numpy(params)
    got, t = t_ckpt.load_ckpt(str(tmp_path / "j"), like, 7)
    assert t == 7
    for a, b in zip(params_np(got), params_np(params)):
        np.testing.assert_array_equal(a, b)
    t_ckpt.save_ckpt(str(tmp_path / "t"), got, 9)
    back, t = j_ckpt.load_ckpt(str(tmp_path / "t"), params, 9)
    assert t == 9
    for a, b in zip(params_np(back), params_np(params)):
        np.testing.assert_array_equal(a, b)
