"""The 3D path's modules against the JAX package, on the CPU.

Module by module: direction sampling on S^2, the 3D radial table and the
Yukawa3D ball quantities, the closed cube's queries (analytic3d), the
estimator's per-point preamble and stratified first directions at D = 3,
the generation executor in the cube (against JAX gen, and alone against
a manufactured solution), then the four 3D scenes' SDFs, sources, hard
boundary conditions, affine (A, c) forms, obstacle rejection and the
nearest-texel lookup on a 3D grid. Inputs come from numpy seeds; smoke's
time-seeded jet jitter goes through the JAX-replay key.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, mc_close, params_np, to_np

from nmcfluid.geometry import analytic3d as j_box3d
from nmcfluid.models.boundary import apply_boundary as j_apply_boundary
from nmcfluid.models.siren import (SirenConfig as JCfg, apply_siren as
                                   j_apply_siren, init_siren as j_init_siren)
from nmcfluid.ops import greens3d as j_greens
from nmcfluid.ops import radial_tables as j_rt
from nmcfluid.ops import sampling as j_dirs
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import NeuralFluid as JFluid
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.wost import WalkSettings as JSettings, WostScene as JScene
from nmcfluid.wost import pool as j_pool
from nmcfluid.wost.gen import estimate_solution_and_gradient_gen as j_gen

import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid_torch.geometry import analytic3d as t_box3d
from nmcfluid_torch.models.boundary import apply_boundary as t_apply_boundary
from nmcfluid_torch.models.siren import (SirenConfig as TCfg, apply_siren as
                                         t_apply_siren, init_siren as
                                         t_init_siren, params_from_numpy)
from nmcfluid_torch.ops import greens3d as t_greens
from nmcfluid_torch.ops import radial_tables as t_rt
from nmcfluid_torch.ops import sampling as t_dirs
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import sampling as t_sampling
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost import pool as t_pool
from nmcfluid_torch.wost.gen import estimate_solution_and_gradient_gen \
    as t_gen
from nmcfluid_torch.wost.solver import (WalkSettings as TSettings,
                                        WostScene as TScene)

SCENES3D = ["smoke", "smoke_obs", "vortex_collide", "karman3d"]
CUBE = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
SIG = 30.0


# ------------------------------------------------------------ directions

def test_unit_sphere_from_u_3d():
    """Uniforms to directions on S^2 and the uniform pdf: rtol 1e-6 /
    atol 1e-6 (cos, sin and sqrt of the same f32 inputs)."""
    u = np.random.default_rng(0).uniform(size=(5000, 2)).astype(np.float32)
    u[:4] = [[0.0, 0.0], [1.0, 0.5], [0.5, 0.25], [1e-7, 0.999]]
    got = to_np(t_dirs.unit_sphere_from_u(torch.from_numpy(u), 3))
    want = np.asarray(j_dirs.unit_sphere_from_u(jnp.asarray(u), 3))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert t_dirs.pdf_unit_sphere(3) == pytest.approx(
        float(j_dirs.pdf_unit_sphere(3)))


# --------------------------------------------------------------- greens

@pytest.fixture(scope="module")
def yukawa():
    return j_greens.Yukawa3D(350.0), t_greens.Yukawa3D(350.0)


def _g3d_double(lam, R, r):
    """The 3D screened ball Green's function in float64 (exact form)."""
    mu = np.sqrt(lam)
    return (np.exp(-mu * r) - np.exp(-mu * R) * np.sinh(mu * r)
            / np.sinh(mu * R)) / (4.0 * np.pi * r)


@pytest.mark.parametrize("lam", [1.0, 350.0])
def test_yukawa3d_matches_double(lam):
    """eval against the float64 formula at tests/test_greens.py:68-76's
    rtol 1e-3 / atol 1e-7."""
    g = t_greens.Yukawa3D(lam)
    R = np.float32(0.53)
    r = np.linspace(0.01, R * 0.999, 64, dtype=np.float32)
    ball = g.make_ball(torch.full((64,), float(R)))
    got = to_np(g.eval(ball, torch.from_numpy(r)))
    np.testing.assert_allclose(got, _g3d_double(lam, np.float64(R),
                                                r.astype(np.float64)),
                               rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("method", ["eval", "dspk", "grad_norm_over_eval",
                                    "norm", "pk_over_uniform",
                                    "pk_grad_over_thr"])
def test_yukawa3d(yukawa, method):
    """Elementwise ball quantities at sigma = 350 over radii from 1e-3 to
    the cube's size, the sample radius below 0.9 R, where G's two terms do
    not cancel. Where Z = sqrt(sigma) R >= 0.3: rtol 1e-5 (f32 rounding of
    the same formulas); norm's 1 - Z e^{-Z}/sh_e(Z) cancels as Z shrinks,
    so it gets 8 f32 ulps of the 1 before the division by sigma as atol.
    Below Z = 0.3 that cancellation (~Z^2/6), and the one in i32e(z) =
    ch_e(z) - sh_e(z)/z of the gradient ratios, put both packages' f32
    values up to 1.7e-2 from the same formula in float64; there the port
    is held to twice the reference's own relative error against float64
    (at least 1e-6)."""
    jg, tg = yukawa
    rng = np.random.default_rng(4)
    R = np.exp(rng.uniform(np.log(1e-3), np.log(3.0), 4000)).astype(
        np.float32)
    r = np.maximum(R * rng.uniform(0.0, 0.9, R.shape), 1e-4).astype(
        np.float32)
    of_ball = method in ("norm", "pk_over_uniform", "pk_grad_over_thr")

    def run(g, ball, radii):
        return getattr(g, method)(*((ball,) if of_ball else (ball, radii)))

    want = np.asarray(run(jg, jg.make_ball(jnp.asarray(R)), jnp.asarray(r)))
    got = to_np(run(tg, tg.make_ball(torch.from_numpy(R)),
                    torch.from_numpy(r)))
    f64 = to_np(run(tg, tg.make_ball(torch.from_numpy(R).double()),
                    torch.from_numpy(r).double()))
    small = R * math.sqrt(350.0) < 0.3
    rel = lambda v: (np.abs(v - f64) / np.abs(f64))[small]
    assert rel(got).max() <= max(2.0 * rel(want).max(), 1e-6)
    atol = 8 * 2.0 ** -23 / 350.0 if method == "norm" else 1e-30
    np.testing.assert_allclose(got[~small], want[~small], rtol=1e-5,
                               atol=atol)


def test_radial_table_3d_and_draw(yukawa):
    """The copied float64 3D table is identical; the port's gather draw
    matches JAX's gather-free matmul draw (the one its Yukawa3D uses) at
    tests/test_greens.py:239's rtol 1e-6 / atol 1e-7, and so does r
    through sample_radius_u; G(r) to rtol 1e-4 where r < 0.9 R."""
    table = t_rt.build_table(3)
    np.testing.assert_array_equal(table, j_rt.build_table(3))
    assert not np.array_equal(table, t_rt.build_table(2))
    rng = np.random.default_rng(5)
    u = np.concatenate([rng.uniform(0.0, 1.0, 4000), [0.0, 1.0, 0.5]])
    Z = np.concatenate([np.exp(rng.uniform(-9.0, 9.0, 4000)),
                        [t_rt._Z_MIN / 10, t_rt._Z_MAX * 10, 1.0]])
    u, Z = u.astype(np.float32), Z.astype(np.float32)
    got = to_np(t_rt.sample_t_screened_u(
        torch.from_numpy(t_rt.pack_quads(table).astype(np.float32)),
        torch.from_numpy(Z), torch.from_numpy(u)))
    want = np.asarray(j_rt.sample_t_screened_u_mm(
        table.astype(np.float32), jnp.asarray(Z), jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    jg, tg = yukawa
    R = (Z / math.sqrt(350.0)).astype(np.float32)
    u2 = np.stack([u, u[::-1]], -1)
    rj, gj = jg.sample_radius_u(jg.make_ball(jnp.asarray(R)),
                                jnp.asarray(u2))
    rt, gt = tg.sample_radius_u(tg.make_ball(torch.from_numpy(R)),
                                torch.from_numpy(u2))
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=1e-6,
                               atol=1e-7)
    inner = to_np(rt) < 0.9 * R
    np.testing.assert_allclose(to_np(gt)[inner], np.asarray(gj)[inner],
                               rtol=1e-4, atol=1e-30)


# --------------------------------------------------------- box queries

def _boxes():
    return (j_box3d.make_box3d((-1.0,) * 3, (1.0,) * 3),
            t_box3d.make_box3d((-1.0,) * 3, (1.0,) * 3))


def _cube_points(seed, n=3000):
    """Mostly inside the cube, some outside, some on faces and edges."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    x[:20, 0] = -1.0
    x[20:40, 2] = 1.0
    x[40:50, :2] = 1.0
    return x


@pytest.mark.parametrize("query", ["distance", "signed_distance",
                                   "dist_to_far_bbox_corner",
                                   "outside_bbox", "star_radius"])
def test_box3d_point_queries(query):
    """rtol 1e-6 / atol 1e-6, as the 2D box queries."""
    jb, tb = _boxes()
    x = _cube_points(6)
    if query == "star_radius":
        mx = np.random.default_rng(7).uniform(0, 3, x.shape[0]).astype(
            np.float32)
        mx[:10] = 1e-4                       # below min_radius
        want = j_box3d.star_radius(jb, jnp.asarray(x), 1e-3,
                                   jnp.asarray(mx))
        got = t_box3d.star_radius(tb, torch.from_numpy(x), 1e-3,
                                  torch.from_numpy(mx))
    else:
        want = getattr(j_box3d, query)(jb, jnp.asarray(x))
        got = getattr(t_box3d, query)(tb, torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_box3d_ray_queries():
    """Hit flags equal; t, point and normal at rtol 1e-6 / atol 1e-6, for
    rays from inside the cube and from its faces, axis-aligned ones
    included."""
    jb, tb = _boxes()
    rng = np.random.default_rng(8)
    o = rng.uniform(-0.95, 0.95, (4000, 3)).astype(np.float32)
    o[:30, 1] = 1.0
    d = rng.normal(size=(4000, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[:10] = [0.0, 0.0, 1.0]
    d[10:20] = [-1.0, 0.0, 0.0]
    tmax = rng.uniform(0.0, 2.5, 4000).astype(np.float32)
    jh = j_box3d.ray_intersect(jb, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmax))
    th = t_box3d.ray_intersect(tb, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(tmax))
    np.testing.assert_array_equal(to_np(th[0]), np.asarray(jh[0]))
    assert 0 < to_np(th[0]).sum() < 4000
    for a, b in zip(th[1:], jh[1:]):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------ estimator preamble

def _pstar(x):
    """p* = cos(pi x) cos(pi y) cos(pi z): its normal derivative vanishes
    on every face of [-1, 1]^3."""
    return np.prod(np.cos(math.pi * x), axis=-1)


def _cube_scene(lib, kind, grid=None):
    """A WoSt scene in the cube: `manufactured`, the screened problem
    (Lap - SIG) p = -(SIG + 3 pi^2) p*, whose solution is p*; or `grid`,
    the fluid's walk, sigma = 350 with a nearest-texel source from a 3D
    divergence grid passed as source_args."""
    if kind == "manufactured":
        c = SIG + 3.0 * math.pi ** 2
        if lib == "jax":
            src = lambda x: c * jnp.prod(jnp.cos(math.pi * x), axis=-1)
            return JScene(dim=3, neumann=_boxes()[0], source_fn=src,
                          absorption=SIG), ()
        src = lambda x: c * torch.prod(torch.cos(math.pi * x), dim=-1)
        return TScene(dim=3, neumann=_boxes()[1], source_fn=src,
                      absorption=SIG), ()
    if lib == "jax":
        return JScene(dim=3, neumann=_boxes()[0],
                      source_fn=lambda y, g: j_sampling.nearest_lookup(
                          g, CUBE, y),
                      absorption=350.0), (jnp.asarray(grid),)
    return TScene(dim=3, neumann=_boxes()[1],
                  source_fn=lambda y, g: t_sampling.nearest_lookup(
                      g, CUBE, y),
                  absorption=350.0), (torch.from_numpy(grid),)


def _walk_points(rng, n):
    """Points in the cube, a few of them next to faces, edges and a
    corner."""
    pts = rng.uniform(-0.98, 0.98, (n, 3))
    pts[:5] = [[-1 + 1e-3, 0.1, 0.2], [0.3, 1 - 4e-3, -0.5],
               [0.99, 0.99, 0.0], [-0.995, -0.995, -0.995],
               [0.0, 0.0, 1 - 2e-2]]
    return pts.astype(np.float32)


def test_precompute_3d():
    """pool._precompute at D = 3: the first ball's radius, its Ball
    fields, the degenerate flags, the Cranley-Patterson rotation (drawn
    from the same key) and the first ball's norm, throughput and gradient
    coefficient, against the columns of JAX's packed row: rtol 1e-5 /
    atol 1e-7 (the Yukawa3D tolerance), the rotation exactly."""
    rng = np.random.default_rng(1)
    pts = _walk_points(rng, 256)
    pts[5] = [1.0, 0.2, 0.3]                          # on a face
    grid = rng.normal(size=(8, 8, 8)).astype(np.float32)
    js, _ = _cube_scene("jax", "grid", grid)
    ts, _ = _cube_scene("torch", "grid", grid)
    key = jax.random.PRNGKey(9)
    jpd = j_pool._precompute(js, JSettings(), jnp.asarray(pts), key)
    tpd = t_pool._precompute(ts, TSettings(), torch.from_numpy(pts),
                             JaxKey(key))
    packed = np.asarray(jpd.packed)
    D = 3
    np.testing.assert_array_equal(to_np(tpd.rot), packed[:, D:2 * D - 1])
    np.testing.assert_array_equal(to_np(tpd.degenerate),
                                  np.asarray(jpd.degenerate))
    assert to_np(tpd.degenerate)[5]
    for got, col in ((tpd.R1, 2 * D - 1), (tpd.norm1, 2 * D),
                     (tpd.thr1, 2 * D + 1), (tpd.bgd, 2 * D + 2)):
        np.testing.assert_allclose(to_np(got), packed[:, col], rtol=1e-5,
                                   atol=1e-7)
    for got, want in zip(tpd.ball1, jpd.ball1):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("n_pairs", [1, 8, 24, 250])
@pytest.mark.parametrize("salt, shift", [(8, 0.0), (12, 0.5)])
def test_strat_dir_3d(n_pairs, salt, shift):
    """The stratified first direction at D = 3 over every pair of a
    near-square grid (a = ceil(sqrt(n_pairs)) columns), with the two
    fastrand jitters at `salt` and `salt + 1` and a per-point rotation:
    rtol 1e-6 / atol 1e-6 (the same f32 formula), and each pair's
    direction a unit vector."""
    rng = np.random.default_rng(n_pairs)
    N = 16
    rot = rng.uniform(size=(N, 2)).astype(np.float32)
    w = np.arange(n_pairs).reshape(-1, 1, 1)
    i = np.arange(N).reshape(1, 1, N)
    seed2 = 0x1234ABCD
    want = np.asarray(j_pool._strat_dir(
        seed2, jnp.asarray(w, jnp.int32), jnp.asarray(i, jnp.int32), salt,
        jnp.asarray(rot), shift, n_pairs, 3))
    got = to_np(t_pool._strat_dir(
        seed2, torch.from_numpy(w), torch.from_numpy(i), salt,
        torch.from_numpy(rot), shift, n_pairs, 3))
    assert got.shape == (n_pairs, 1, N, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


# ------------------------------------------------------- the executor

@pytest.mark.parametrize("case", ["manufactured", "grid"])
def test_gen_matches_jax_gen_3d(case):
    """The generation executor in the cube against JAX gen, both with the
    same streams: 48 walks (so the frozen control variates engage), the
    same valid counts, p at rtol 2e-4 / atol 2e-5 and grad p at rtol 2e-3
    / atol 2e-4 (tests/test_gen.py:45-60, gen vs pool). `grid` is the
    fluid's walk: sigma = 350 and a nearest-texel source on an 80^3
    grid."""
    rng = np.random.default_rng(2)
    pts = _walk_points(rng, 48)
    grid = rng.normal(size=(80, 80, 80)).astype(np.float32) \
        if case == "grid" else None
    js, jargs = _cube_scene("jax", case, grid)
    ts, targs = _cube_scene("torch", case, grid)
    key = jax.random.PRNGKey(3)
    p_j, g_j, n_j = j_gen(js, JSettings(algo="gen"), jnp.asarray(pts), key,
                          48, source_args=jargs)
    p_t, g_t, n_t = t_gen(ts, TSettings(algo="gen"), torch.from_numpy(pts),
                          JaxKey(key), 48, source_args=targs)
    np.testing.assert_array_equal(to_np(n_t), np.asarray(n_j))
    assert to_np(n_t).min() > 0
    np.testing.assert_allclose(to_np(p_t), np.asarray(p_j), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(to_np(g_t), np.asarray(g_j), rtol=2e-3,
                               atol=2e-4)


MANUFACTURED_3D_WALKS = 32000


def test_gen_solves_manufactured_problem_3d():
    """The port alone, with its own key, on (Lap - SIG) p = -(SIG + 3 pi^2)
    p* with p* = cos(pi x) cos(pi y) cos(pi z), whose flux through every
    face of [-1, 1]^3 is zero: p and grad p at the 2D oracle's tolerances
    (tests/test_gen.py:63-76: atol 0.05 and 0.15) and every point's walks
    but a few valid. JAX gen's 3D path has no unit oracle of its own. The
    gradient's error has a heavy tail: over keys 0-11 it reached 0.30,
    twice the atol, at 2,000 walks and 0.163 at 8,000 under the port's
    key; MANUFACTURED_3D_WALKS is sized so that no key of the audit
    (port_key_audit.py) reads over 80% of it. Generations of 1024 pairs
    take the same walks in fewer, wider steps."""
    pts = np.asarray([[0.0, 0.0, 0.0], [0.3, -0.4, 0.2],
                      [-0.6, 0.5, 0.7], [0.8, 0.1, -0.3]], np.float32)
    scene, _ = _cube_scene("torch", "manufactured")
    p, grad, n = t_gen(scene, TSettings(algo="gen", gen_group_pairs=1024),
                       torch.from_numpy(pts), Key(0), MANUFACTURED_3D_WALKS)
    mc_close(p, _pstar(pts), 0.05, "p")
    s, c = np.sin(math.pi * pts), np.cos(math.pi * pts)
    want = -math.pi * np.stack([s[:, 0] * c[:, 1] * c[:, 2],
                                c[:, 0] * s[:, 1] * c[:, 2],
                                c[:, 0] * c[:, 1] * s[:, 2]], -1)
    mc_close(grad, want, 0.15, "grad p")
    assert np.all(to_np(n) > 0.85 * MANUFACTURED_3D_WALKS)


# -------------------------------------------------------------- scenes

def _scenes(name):
    return j_get_scene(name), t_get_scene(name)


def _scene_points(name, n, seed):
    """Points over the cube and a margin around it, with shares in the
    jet spheres, on and near the obstacle, in the ramps along the walls
    and in karman3d's inlet band."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.05, 1.05, (n, 3))
    k = n // 8
    jet = np.array([0.0, 0.0, -0.6])
    x[:k] = jet + rng.normal(scale=0.07, size=(k, 3))     # smoke jets
    x[k:2 * k] = np.array([0.2, 0.2, 0.0]) + rng.normal(
        scale=0.15, size=(k, 3)) * [1, 1, 1.5]            # vortex rings
    m = 2 * k
    if name == "smoke_obs":
        d = rng.normal(size=(k, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        x[m:m + k] = [0.0, 0.0, -0.3] + d * rng.uniform(0.08, 0.14, (k, 1))
    if name == "karman3d":
        ang = rng.uniform(0, 2 * np.pi, k)
        rad = rng.uniform(0.08, 0.14, k)
        x[m:m + k, 0] = rad * np.cos(ang)
        x[m:m + k, 2] = -0.8 + rad * np.sin(ang)
        x[m + k:m + k + 40, 2] = -1.0 + rng.uniform(0.0, 0.012, 40)
    axis = rng.integers(0, 3, k)
    x[-k:][np.arange(k), axis] = rng.choice([-1.0, 1.0], k) * (
        1.0 - rng.uniform(-0.005, 0.015, k))              # near the walls
    return x.astype(np.float32)


@pytest.mark.parametrize("name", SCENES3D)
def test_scene_sdf_mask_and_source(name):
    """obstacle_sdf (smoke_obs's sphere, karman3d's cylinder), fluid_mask
    and source_velocity: atol 1e-6; smoke's source jitter from the same
    key (JAX-replay)."""
    js, ts = _scenes(name)
    x = _scene_points(name, 4000, 3)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert ts.has_obstacle == js.has_obstacle
    if js.has_obstacle:
        np.testing.assert_allclose(to_np(ts.obstacle_sdf(tx)),
                                   np.asarray(js.obstacle_sdf(jx)), rtol=0,
                                   atol=1e-6)
    mask = to_np(ts.fluid_mask(tx))
    np.testing.assert_array_equal(mask, np.asarray(js.fluid_mask(jx)))
    assert mask.all() != js.has_obstacle
    k = jax.random.PRNGKey(13)
    got = to_np(ts.source_velocity(tx, key=JaxKey(k)))
    want = np.asarray(js.source_velocity(jx, key=k))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() > 0.1


@pytest.mark.parametrize("name", SCENES3D)
@pytest.mark.parametrize("t", [0, 3])
def test_boundary_and_velocity_affine_3d(name, t):
    """apply_boundary and the affine (A, c) form the fused fit takes, at
    the scenes' ramp width, timesteps 0 and 3: atol 1e-6. smoke's jet
    jitter comes from the key of seed 7 folded with t, through the
    JAX-replay key in both the policy and the fluid's velocity_affine
    (whose key init_state makes of the state key's class)."""
    js, ts = _scenes(name)
    x = _scene_points(name, 3000, 5)
    raw = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    eps = js.bdry_eps
    want = j_apply_boundary(js, jnp.asarray(raw), jx, eps=jnp.float32(eps),
                            t=t, key=jax.random.PRNGKey(7))
    got = t_apply_boundary(ts, torch.from_numpy(raw), tx, eps=eps, t=t,
                           key=JaxKey.from_seed(7))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)
    sizes = dict(sample_resolution=8, wost_resolution=8, div_resolution=8)
    jf = JFluid(js, **sizes)
    jA, jc = jf.velocity_affine(jx, eps=jnp.float32(eps), t=t)
    tf = tfluid.NeuralFluid(ts, device="cpu", **sizes)
    tf.init_state(key=JaxKey.from_seed(0))
    tA, tc = tf.velocity_affine(tx, eps=eps, t=t)
    assert tA.shape == (3000, 3, 3) and tc.shape == (3000, 3)
    np.testing.assert_allclose(to_np(tA), np.asarray(jA), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=0, atol=1e-6)
    if name in ("smoke", "smoke_obs", "karman3d"):
        assert np.abs(to_np(tc)).max() > 0.1      # the clamped regions
    np.testing.assert_allclose(
        to_np(tf.velocity(params_from_numpy(_net_params(name, 2)), tx,
                          eps=eps, t=t)),
        np.asarray(jf.velocity(_net_params(name, 2), jx,
                               eps=jnp.float32(eps), t=t)),
        rtol=1e-4, atol=2e-5)


def test_smoke_jitter_follows_the_timestep():
    """The jet's jitter differs between timesteps and repeats within one."""
    ts = t_get_scene("smoke")
    x = torch.from_numpy(_scene_points("smoke", 2000, 7))
    vel = torch.zeros_like(x)
    k = JaxKey.from_seed(7)
    a, b, c = (t_apply_boundary(ts, vel, x, eps=1e-2, t=t, key=k)
               for t in (1, 2, 1))
    assert torch.equal(a, c) and not torch.equal(a, b)


@pytest.mark.parametrize("name", ["smoke_obs", "karman3d"])
@pytest.mark.parametrize("rounds", [1, 8])
def test_fluid_points_3d_replay_jax_keys(name, rounds):
    """Rejection off smoke_obs's sphere and karman3d's cylinder with the
    JAX-replay key: the same valid flags and the same points to an ulp of
    the cube's coordinates (atol 1.2e-7: XLA may fuse lo + u (hi - lo)
    into an FMA)."""
    js, ts = _scenes(name)
    ulp = float(np.spacing(np.float32(1.0)))
    k = jax.random.PRNGKey(21)
    jp, jv = j_sampling.fluid_points(k, 20000, js, rounds=rounds)
    tp, tv = t_sampling.fluid_points(JaxKey(k), 20000, ts, rounds=rounds)
    np.testing.assert_allclose(to_np(tp), np.asarray(jp), rtol=0, atol=ulp)
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
    assert np.all(to_np(ts.fluid_mask(tp))[to_np(tv)])


def test_nearest_lookup_and_grid_3d():
    """The 80^3 divergence grid's cell-centred points and the walk's
    nearest-texel source on a 3D grid, clamped outside the cube: grid at
    rtol 1e-6, lookup exactly."""
    np.testing.assert_allclose(
        to_np(t_sampling.uniform_grid(CUBE, 80)),
        np.asarray(j_sampling.uniform_grid(CUBE, 80)), rtol=1e-6)
    rng = np.random.default_rng(9)
    grid = rng.normal(size=(80, 80, 80)).astype(np.float32)
    y = rng.uniform(-1.2, 1.2, (20000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(t_sampling.nearest_lookup(torch.from_numpy(grid), CUBE,
                                        torch.from_numpy(y))),
        np.asarray(j_sampling.nearest_lookup(jnp.asarray(grid), CUBE,
                                             jnp.asarray(y))))


def _net_params(name, seed):
    """The scene's SIREN (3 -> 3) from a JAX seed, with trained-looking
    biases."""
    js = j_get_scene(name)
    cfg = JCfg(3, 3, js.num_hidden_layers, js.hidden_features)
    params = j_init_siren(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    return [(W, b + 0.05 * rng.normal(size=b.shape).astype(np.float32))
            for W, b in params]


@pytest.mark.parametrize("name", ["smoke", "karman3d"])
def test_siren_3d_init_and_forward(name):
    """The 5 x 64 and 2 x 128 nets on 3D inputs: init_siren replays JAX's
    draws exactly, the forward agrees at the SIREN tolerance (rtol 1e-4 /
    atol 2e-5), and the fluid builds the JAX package's divergence grid and
    point counts."""
    js, ts = _scenes(name)
    jcfg = JCfg(3, 3, js.num_hidden_layers, js.hidden_features)
    tcfg = TCfg(3, 3, ts.num_hidden_layers, ts.hidden_features)
    want = j_init_siren(jax.random.PRNGKey(5), jcfg)
    got = t_init_siren(JaxKey.from_seed(5), tcfg)
    for a, b in zip(params_np(got), params_np(want)):
        np.testing.assert_array_equal(a, b)
    params = _net_params(name, 5)
    x = _scene_points(name, 1000, 8)
    np.testing.assert_allclose(
        to_np(t_apply_siren(params_from_numpy(params), tcfg,
                            torch.from_numpy(x))),
        np.asarray(j_apply_siren(params, jcfg, jnp.asarray(x))), rtol=1e-4,
        atol=2e-5)
    tf = tfluid.NeuralFluid(ts, device="cpu", sample_resolution=8,
                            wost_resolution=8)
    jf = JFluid(js, sample_resolution=8, wost_resolution=8)
    assert tf.div_resolution == jf.div_resolution == 80
    assert (tf.n_batch, tf.n_pressure) == (jf.n_batch, jf.n_pressure)


@pytest.mark.parametrize("name", ["smoke", "karman3d"])
def test_scene_pool_3d(name):
    """fitprobe.scene_pool, the pool chip_smoke.py holds the fit kernel to
    its twin on, at D = 3 on the CPU: the kernel's shapes, the scene's
    hard-BC (A, c) at its points, weight 0 exactly where the obstacle's
    SDF is negative, and the same pool again from the same seed."""
    from nmcfluid_torch.sim.fitprobe import scene_pool
    f = tfluid.NeuralFluid(t_get_scene(name), device="cpu",
                           sample_resolution=16)
    x, A, c, tgt, w = scene_pool(f, 2, 3)
    assert (x.shape, A.shape, c.shape, tgt.shape, w.shape) == (
        (2, 256, 3), (2, 256, 3, 3), (2, 256, 3), (2, 256, 3), (2, 256))
    A2, c2 = f.velocity_affine(x, eps=f.scene.bdry_eps, t=0)
    assert torch.equal(A, A2) and torch.equal(c, c2)
    assert torch.equal(w, f.scene.fluid_mask(x).to(torch.float32))
    assert all(torch.equal(a, b) for a, b in zip(scene_pool(f, 2, 3),
                                                  (x, A, c, tgt, w)))
