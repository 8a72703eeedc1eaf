"""The rest of the walk-on-stars family against the JAX package, on the CPU.

The harmonic Green's functions and the screened ones' remaining methods
(tests/test_greens.py's quantities), one `_advance` step of every branch
on fixed states and fixed draws (Dirichlet termination, nonzero and
double-sided Neumann data, mid-walk Tikhonov, maximal spheres,
ignore_source, sigma = 0), the solution-only walk `estimate_solution`
under both RNGs (tests/test_wost.py, test_dirichlet.py,
test_neumann_data.py, test_doublesided.py), the walker pool against JAX's
pool and against the port's gen on the same streams (tests/test_pool.py,
test_gen.py), gen with Dirichlet data against JAX's gen, and the 3D walk
with Harmonic3D in the cube. Both packages take the same draws: the
JAX-replay key for jax.random, fastrand for the walks' streams. Where the
two agree to reduction order the tolerances are tests/test_gen.py's (p
rtol 2e-4 / atol 2e-5, grad rtol 2e-3 / atol 2e-4); the manufactured
solutions are held at the JAX tests' atol.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, mc_below, mc_close, to_np

from nmcfluid.geometry import analytic3d as j_a3
from nmcfluid.geometry import soup2d as j_soup
from nmcfluid.ops import greens2d as j_g2, greens3d as j_g3
from nmcfluid.wost import pool as j_pool
from nmcfluid.wost import solver as j_solver
from nmcfluid.wost.gen import estimate_solution_and_gradient_gen as j_gen

from nmcfluid_torch.geometry import analytic3d as t_a3
from nmcfluid_torch.geometry import box_tris, build_triangles
from nmcfluid_torch.geometry import soup2d as t_soup
from nmcfluid_torch.ops import greens2d as t_g2, greens3d as t_g3
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost import solver as t_solver

L = 2.0
KX = math.pi / L
SIG_D = 5.0        # tests/test_dirichlet.py's mild screening
P_TOL = dict(rtol=2e-4, atol=2e-5)
G_TOL = dict(rtol=2e-3, atol=2e-4)


class _Lib:
    """The pieces of one package the scenes below are built from."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.np = jnp if self.jax else torch
        self.soup = j_soup if self.jax else t_soup
        self.solver = j_solver if self.jax else t_solver

    def arr(self, a):
        a = np.asarray(a)
        return jnp.asarray(a) if self.jax else torch.from_numpy(a.copy())

    def where(self, c, a, b):
        return jnp.where(c, a, b) if self.jax else torch.where(c, a, b)

    def key(self, seed):
        k = jax.random.PRNGKey(seed)
        return k if self.jax else JaxKey(k)


LIBS = {n: _Lib(n) for n in ("jax", "torch")}


def _p_star(lib, x):
    return lib.np.cos(KX * x[..., 0]) * lib.np.cos(KX * x[..., 1])


def mixed_scene(lib, sigma=SIG_D, neumann_data=False):
    """tests/test_dirichlet.py's box: Neumann x-walls, Dirichlet y-walls
    with p* = cos(KX x) cos(KX y); with neumann_data, a nonzero flux h on
    the Neumann walls (the estimator's boundary term then runs; the
    manufactured solution no longer holds)."""
    s, S = lib.soup, lib.solver
    neumann = s.build_segments([s.polyline_chain([(0.0, L), (0.0, 0.0)]),
                                s.polyline_chain([(L, 0.0), (L, L)])])
    dirichlet = s.build_segments([s.polyline_chain([(0.0, 0.0), (L, 0.0)]),
                                  s.polyline_chain([(L, L), (0.0, L)])])
    h = (lambda x: 0.4 * lib.np.sin(KX * x[..., 1])) if neumann_data \
        else None
    return S.WostScene(
        dim=2, neumann=neumann,
        source_fn=lambda x: (sigma + 2.0 * KX ** 2) * _p_star(lib, x),
        absorption=sigma, dirichlet=dirichlet,
        dirichlet_fn=lambda x: _p_star(lib, x), neumann_fn=h)


# tests/test_doublesided.py's barrier: Neumann top/bottom walls and a
# full-height barrier at x = M solved double-sided, Dirichlet left/right
M, SIG_B, CL, CR = 0.8, 10.0, 1.0, 2.0
KL, KR = math.pi / M, math.pi / (L - M)


def _p_barrier(lib, x):
    xx = x[..., 0]
    return lib.where(xx < M, CL * lib.np.cos(KL * xx),
                     CR * lib.np.cos(KR * (L - xx)))


def barrier_scene(lib, ds_data=False):
    s, S = lib.soup, lib.solver
    neumann = s.build_segments(
        [s.polyline_chain([(0.0, 0.0), (L, 0.0)]),
         s.polyline_chain([(L, L), (0.0, L)]),
         s.polyline_chain([(M, 0.0), (M, L)])], double_sided=True)
    dirichlet = s.build_segments([s.polyline_chain([(0.0, L), (0.0, 0.0)]),
                                  s.polyline_chain([(L, 0.0), (L, L)])])

    def src(x):
        xx = x[..., 0]
        return lib.where(xx < M, (SIG_B + KL ** 2) * CL * lib.np.cos(KL * xx),
                         (SIG_B + KR ** 2) * CR * lib.np.cos(KR * (L - xx)))
    kw = {}
    if ds_data:
        # side-dependent data: exercise the aligned flag and the side
        kw = dict(neumann_ds_fn=lambda x, al: lib.where(al, 0.3, -0.2)
                  * lib.np.cos(x[..., 1]),
                  dirichlet_ds_fn=lambda x, side: _p_barrier(lib, x)
                  + lib.where(side, 0.1, 0.0))
    return S.WostScene(dim=2, neumann=neumann, source_fn=src,
                       absorption=SIG_B, dirichlet=dirichlet,
                       dirichlet_fn=lambda x: _p_barrier(lib, x), **kw)


# ------------------------------------------------------ Green's functions

def _balls(rng, n=256):
    R = rng.uniform(1e-3, 2.0, n).astype(np.float32)
    r = (R * rng.uniform(0.02, 0.98, n)).astype(np.float32)
    return R, r


@pytest.mark.parametrize("dim", [2, 3])
def test_harmonic_greens_match_jax(dim):
    """Every method of Harmonic2D/3D against the JAX class at rtol 1e-5
    (the same float32 formulas), the radius draws from the same uniforms
    too (the 2D table lookup against the JAX package's gather-free form,
    bit-identical by radial_tables.py:153)."""
    rng = np.random.default_rng(dim)
    R, r = _balls(rng)
    u2 = rng.uniform(0, 1, (len(R), 2)).astype(np.float32)
    jg = j_g2.Harmonic2D if dim == 2 else j_g3.Harmonic3D
    tg = t_g2.Harmonic2D if dim == 2 else t_g3.Harmonic3D
    jb, tb = jg.make_ball(jnp.asarray(R)), tg.make_ball(torch.tensor(R))
    jr, tr = jnp.asarray(r), torch.tensor(r)
    for m in ("eval", "dspk", "grad_norm", "grad_norm_over_eval",
              "radial_pdf"):
        np.testing.assert_allclose(to_np(getattr(tg, m)(tb, tr)),
                                   np.asarray(getattr(jg, m)(jb, jr)),
                                   rtol=1e-5, atol=1e-7, err_msg=m)
    for m in ("norm", "pk_over_uniform", "pk_grad_coeff",
              "pk_grad_over_thr") + (("rejection_bound",) if dim == 2
                                     else ()):
        np.testing.assert_allclose(to_np(getattr(tg, m)(tb)),
                                   np.asarray(getattr(jg, m)(jb)),
                                   rtol=1e-5, err_msg=m)
    (rt, gt), (rj, gj) = tg.sample_radius_u(tb, torch.tensor(u2)), \
        jg.sample_radius_u(jb, jnp.asarray(u2))
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=2e-6)
    np.testing.assert_allclose(to_np(gt), np.asarray(gj), rtol=2e-5,
                               atol=1e-7)


@pytest.mark.parametrize("dim", [2, 3])
def test_yukawa_remaining_methods_and_rejection_match_jax(dim):
    """Yukawa's pk_grad_coeff, grad_norm, radial_pdf and rejection_bound,
    and sample_radius_rejection from the uniforms jax.random draws for it
    (the JAX-replay key), against the JAX package. Above Z = 0.3 at rtol
    1e-5; 3D's f32 cancellation below it (ROADMAP queue 3, item 10) is
    kept out by the radii."""
    rng = np.random.default_rng(10 + dim)
    R, r = _balls(rng)
    R = np.maximum(R, 0.05).astype(np.float32)
    r = (R * rng.uniform(0.05, 0.95, len(R))).astype(np.float32)
    jg = (j_g2.Yukawa2D if dim == 2 else j_g3.Yukawa3D)(30.0)
    tg = (t_g2.Yukawa2D if dim == 2 else t_g3.Yukawa3D)(30.0)
    jb, tb = jg.make_ball(jnp.asarray(R)), tg.make_ball(torch.tensor(R))
    jr, tr = jnp.asarray(r), torch.tensor(r)
    for m in ("grad_norm", "radial_pdf"):
        np.testing.assert_allclose(to_np(getattr(tg, m)(tb, tr)),
                                   np.asarray(getattr(jg, m)(jb, jr)),
                                   rtol=2e-5, atol=1e-7, err_msg=m)
    for m in ("pk_grad_coeff", "rejection_bound"):
        np.testing.assert_allclose(to_np(getattr(tg, m)(tb)),
                                   np.asarray(getattr(jg, m)(jb)),
                                   rtol=1e-5, err_msg=m)
    key = jax.random.PRNGKey(5)
    rj, gj = j_g2.sample_radius_rejection(jg, jb, key, rounds=16)
    u = JaxKey(key).uniform((2, 16) + R.shape, "cpu")
    rt, gt = t_g2.sample_radius_rejection(tg, tb, u)
    np.testing.assert_allclose(to_np(rt), np.asarray(rj), rtol=1e-6)
    np.testing.assert_allclose(to_np(gt), np.asarray(gj), rtol=2e-5,
                               atol=1e-7)


# ---------------------------------------------------------- one step

def _fixed_state(lib, rng, n=96, double_sided=False):
    """Walker states in the box: most in the interior, a share on the
    x-walls (or on the barrier) with their normals, a few terminated,
    mixed step counts; flipped set on some boundary lanes."""
    x = rng.uniform(0.05, L - 0.05, (n, 2)).astype(np.float32)
    nrm = np.zeros((n, 2), np.float32)
    on = np.zeros(n, bool)
    k = n // 3
    if double_sided:
        # on the barrier x = M, from either side; stored normals face the
        # walker's own side
        side = rng.integers(0, 2, k) * 2 - 1
        x[:k, 0] = M
        nrm[:k, 0] = -side
    else:
        wall = rng.integers(0, 2, k)
        x[:k, 0] = wall * L
        nrm[:k, 0] = wall * 2.0 - 1.0
    on[:k] = True
    flipped = np.zeros(n, bool)
    if double_sided:
        flipped[:k] = rng.uniform(size=k) < 0.5
    status = np.where(rng.uniform(size=n) < 0.1, 1, 0).astype(np.int32)
    steps = rng.integers(0, 6, n).astype(np.int32)
    thr = rng.uniform(0.5, 1.5, n).astype(np.float32)
    acc = rng.normal(size=n).astype(np.float32)
    fields = dict(x=x, n=nrm, on_neumann=on, thr=thr, acc=acc, steps=steps,
                  status=status, first_radius=np.zeros(n, np.float32),
                  flipped=flipped)
    if not lib.jax:
        fields["steps"] = steps.astype(np.int64)
        fields["status"] = status.astype(np.int64)
    return lib.solver.WalkState(**{k_: lib.arr(v) for k_, v in
                                   fields.items()})


ADVANCE_CASES = {
    # Dirichlet termination in the shell and nonzero Neumann data
    "mixed": (lambda lib: mixed_scene(lib, neumann_data=True), {}, False),
    # the double-sided normal flip, the aligned flag, per-step reset
    "double_sided": (lambda lib: barrier_scene(lib, ds_data=True),
                     dict(solve_double_sided=True), True),
    # harmonic for the first 3 steps, screened after, per lane
    "tikhonov": (lambda lib: mixed_scene(lib, neumann_data=True),
                 dict(steps_before_tikhonov=3), False),
    "maximal_spheres": (lambda lib: mixed_scene(lib),
                        dict(steps_before_maximal_spheres=2), False),
    "ignore_source": (lambda lib: mixed_scene(lib, neumann_data=True),
                      dict(ignore_source=True), False),
    "harmonic": (lambda lib: mixed_scene(lib, sigma=0.0), {}, False),
}


@pytest.mark.parametrize("case", sorted(ADVANCE_CASES))
def test_advance_branch_matches_jax(case):
    """One `_advance` step of each branch on the same states and the same
    draws (one numpy seed a salt): positions, normals and throughputs at
    rtol 1e-5, the accumulator at the walk's p tolerance, the flags and
    codes equal."""
    build, over, ds = ADVANCE_CASES[case]
    out = {}
    for name, lib in LIBS.items():
        scene = build(lib)
        settings = lib.solver.WalkSettings(ignore_dirichlet=False, **over)
        st = _fixed_state(lib, np.random.default_rng(7), double_sided=ds)

        def draw(salt, shape, lib=lib):
            u = np.random.default_rng(100 + salt).uniform(
                size=shape).astype(np.float32)
            return lib.arr(u)
        out[name] = lib.solver._advance(scene, scene.greens(), settings, st,
                                        draw)
    j, t = out["jax"], out["torch"]
    for f in ("on_neumann", "steps", "status", "flipped"):
        np.testing.assert_array_equal(to_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("x", "n", "thr"):
        np.testing.assert_allclose(to_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(to_np(t.acc), np.asarray(j.acc), **P_TOL)
    # the branch did something
    assert (np.asarray(j.status) != 0).sum() > 0


# ------------------------------------------------ the solution-only walk

PTS_D = np.asarray([[1.0, 0.35], [0.5, 0.7], [1.5, 1.65], [0.3, 1.2]],
                   np.float32)


@pytest.fixture(scope="module")
def solution_runs():
    """estimate_solution in both packages on the mixed problem (both
    RNGs) and on the barrier (double-sided), the same keys."""
    runs = {}
    for case, build, over, pts, seed in (
            ("fast", mixed_scene, {}, PTS_D, 0),
            ("threefry", mixed_scene, dict(fast_rng=False), PTS_D, 0),
            ("barrier", barrier_scene, dict(solve_double_sided=True),
             np.asarray([[0.3, 1.0], [0.55, 0.5], [0.95, 1.0], [1.6, 1.4]],
                        np.float32), 1)):
        for name, lib in LIBS.items():
            scene = build(lib)
            s = lib.solver.WalkSettings(walk_step_cap=256,
                                        ignore_dirichlet=False, **over)
            runs[case, name] = [to_np(a) for a in lib.solver.
                                estimate_solution(scene, s, lib.arr(pts),
                                                  lib.key(seed), 1024)]
        runs[case, "pts"] = pts
    return runs


@pytest.mark.parametrize("case", ["fast", "threefry", "barrier"])
def test_estimate_solution_matches_jax(solution_runs, case):
    """The same walks: equal valid counts, p at the walk's tolerance, the
    mean step count within one step in a thousand (a walk whose ray test
    ties at a rounding error may take another step)."""
    (pt, nt, mt), (pj, nj, mj) = (solution_runs[case, "torch"],
                                  solution_runs[case, "jax"])
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(pt, pj, **P_TOL)
    np.testing.assert_allclose(mt, mj, rtol=1e-3)


def test_estimate_solution_manufactured():
    """The port alone with its own key, at tests/test_dirichlet.py's and
    test_doublesided.py's sizes and atol: the mixed problem (3000 walks,
    atol 0.05), the barrier (atol 0.08, 10,000 walks: at 3000 a key of
    keys 0-11 read 83% of it, at 4000 81%, port_key_audit.py), and
    dropping the
    terminal Dirichlet data moves the estimate by more than 0.15."""
    lib = LIBS["torch"]
    scene = mixed_scene(lib)
    s = t_solver.WalkSettings(walk_step_cap=256, ignore_dirichlet=False)
    pts = torch.from_numpy(PTS_D)
    p, n, _ = t_solver.estimate_solution(scene, s, pts, Key(0), 3000)
    mc_close(p, _p_star(lib, pts), 0.05, "p")
    assert np.all(to_np(n) > 2000)
    p0, _, _ = t_solver.estimate_solution(
        scene, dataclasses.replace(s, ignore_dirichlet=True), pts, Key(0),
        3000)
    mc_below(0.15, (p0 - p).abs().max(), "the Dirichlet data moves p")
    bpts = torch.tensor([[0.3, 1.0], [0.55, 0.5], [1.1, 1.0], [1.6, 1.4]])
    pb, nb, _ = t_solver.estimate_solution(
        barrier_scene(lib), dataclasses.replace(s, solve_double_sided=True),
        bpts, Key(1), 10000)
    mc_close(pb, _p_barrier(lib, bpts), 0.08, "p at the barrier")
    assert np.all(to_np(nb) > 6666)


def test_neumann_data_walk_manufactured():
    """tests/test_neumann_data.py's 2D problem: p* = cos(K x) on the box,
    flux -K on the x = L wall only; the boundary term must carry it
    (atol 0.06 at 3000 walks; leaving it out lands farther off)."""
    K = math.pi / (2.0 * L)
    sig = 30.0

    def h(x):
        return torch.where(x[..., 0] > L - 1e-4, -K * torch.sin(K * x[..., 0]),
                           0.0)
    soup = t_soup.build_segments([t_soup.box_loop(0.0, L, 0.0, L, 4)])
    scene = t_solver.WostScene(
        dim=2, neumann=soup, absorption=sig, neumann_fn=h,
        source_fn=lambda x: (sig + K ** 2) * torch.cos(K * x[..., 0]))
    pts = torch.tensor([[1.0, 1.0], [1.7, 0.6], [0.5, 1.4]])
    s = t_solver.WalkSettings(walk_step_cap=96)
    p, n, _ = t_solver.estimate_solution(scene, s, pts, Key(0), 3000)
    want = torch.cos(K * pts[:, 0])
    mc_close(p, want, 0.06, "p")
    p0, _, _ = t_solver.estimate_solution(
        scene, dataclasses.replace(s, ignore_neumann=True), pts, Key(0),
        3000)
    mc_below(abs(float(p[1] - want[1])), abs(float(p0[1] - want[1])),
             "the flux's error below the flux-free error")


# ------------------------------------------------ the gradient executors

@pytest.fixture(scope="module")
def box_scenes():
    """tests/test_pool.py's box (a 16-segment soup, sigma 30) and its 4
    points of tests/test_gen.py."""
    out = {}
    for name, lib in LIBS.items():
        soup = lib.soup.build_segments(
            [lib.soup.box_loop(0.0, L, 0.0, L, n_per_side=4)])
        out[name] = lib.solver.WostScene(
            dim=2, neumann=soup, absorption=30.0,
            source_fn=lambda x, lib=lib: (30.0 + 2 * KX ** 2)
            * _p_star(lib, x))
    return out


PTS_G = np.asarray([[1.0, 1.0], [0.4, 0.7], [1.5, 1.6], [0.2, 1.1]],
                   np.float32)
CAPS = dict(walk_step_cap=64, pool_step_cap=64, gen_step_cap=64)


@pytest.fixture(scope="module")
def pool_runs(box_scenes):
    """JAX's pool, the port's pool (default slots, 256 slots, refill
    every 4 steps) and the port's gen at 64 walks on key 3."""
    key = jax.random.PRNGKey(3)
    js = j_solver.WalkSettings(algo="pool", **CAPS)
    runs = {"jax": j_pool.estimate_solution_and_gradient_pool(
        box_scenes["jax"], js, jnp.asarray(PTS_G), key, 64)}
    for tag, over in (("pool", {}), ("slots", dict(pool_slots=256)),
                      ("refill", dict(pool_refill_every=4)),
                      ("gen", dict(algo="gen"))):
        s = t_solver.WalkSettings(**dict(dict(algo="pool", **CAPS), **over))
        runs[tag] = t_solver.estimate_solution_and_gradient(
            box_scenes["torch"], s, torch.from_numpy(PTS_G), JaxKey(key),
            64)
    return {k: [to_np(a) for a in v] for k, v in runs.items()}


@pytest.mark.parametrize("other", ["jax", "slots", "refill", "gen"])
def test_pool_matches_same_streams(pool_runs, other):
    """The port's pool against JAX's pool, against itself under another
    schedule (tests/test_pool.py: slots and refill interval only reorder
    sums) and against the port's gen (tests/test_gen.py: the same walks,
    the warmup 16 a multiple of gen_group_pairs 4): equal valid counts, p
    and grad at the gen-vs-pool tolerances."""
    (p, g, n), (po, go, no) = pool_runs["pool"], pool_runs[other]
    np.testing.assert_array_equal(n, no)
    np.testing.assert_allclose(p, po, **P_TOL)
    np.testing.assert_allclose(g, go, **G_TOL)


def test_pool_solves_manufactured_problem(box_scenes):
    """tests/test_pool.py::test_pool_matches_analytic on the port alone:
    192 points, 192 walks, mean |p - p*| < 0.03 and |grad - grad p*| <
    0.12, and the antithetic and control variates cut the gradient's
    error (test_pool_antithetic_and_cv_reduce_variance)."""
    pts = torch.from_numpy(np.random.default_rng(3).uniform(
        0.3, 1.7, (192, 2)).astype(np.float32))
    lib = LIBS["torch"]
    x, y = pts[:, 0], pts[:, 1]
    g_true = torch.stack([-KX * torch.sin(KX * x) * torch.cos(KX * y),
                          -KX * torch.cos(KX * x) * torch.sin(KX * y)], -1)
    s = t_solver.WalkSettings(n_walks=192, algo="pool")
    p, g, n = t_solver.estimate_solution_and_gradient(box_scenes["torch"],
                                                      s, pts, Key(7))
    assert int(n.min()) > 150
    mc_below((p - _p_star(lib, pts)).abs().mean(), 0.03, "mean |dp|")
    mc_below((g - g_true).abs().mean(), 0.12, "mean |d grad p|")
    plain = dataclasses.replace(s, n_walks=128,
                                use_gradient_antithetic_variates=False,
                                use_gradient_control_variates=False)
    _, g_plain, _ = t_solver.estimate_solution_and_gradient(
        box_scenes["torch"], plain, pts, Key(9))
    _, g_full, _ = t_solver.estimate_solution_and_gradient(
        box_scenes["torch"], dataclasses.replace(s, n_walks=128), pts,
        Key(9))
    mc_below(((g_full - g_true) ** 2).mean(),
             ((g_plain - g_true) ** 2).mean(),
             "the variates' squared error below the plain one's")


@pytest.mark.parametrize("case", ["dirichlet_gen", "dirichlet_pool",
                                  "barrier_pool", "neumann_gen"])
def test_gradient_with_boundary_data_matches_jax(case):
    """gen with Dirichlet data against JAX's gen, and the pool (the
    oracle of ROADMAP queue 3, item 4) with Dirichlet, double-sided and
    Neumann data against JAX's pool: 48 walks, tests/test_gen.py's
    tolerances."""
    what, algo = case.rsplit("_", 1)
    build = {"dirichlet": mixed_scene, "barrier": barrier_scene,
             "neumann": lambda lib: mixed_scene(lib, neumann_data=True)}[what]
    over = dict(solve_double_sided=True) if what == "barrier" else {}
    pts = PTS_D if what != "barrier" else np.asarray(
        [[0.4, 1.0], [1.3, 0.9], [0.7, 0.3], [1.8, 1.6]], np.float32)
    key = jax.random.PRNGKey(2)
    out = {}
    for name, lib in LIBS.items():
        s = lib.solver.WalkSettings(ignore_dirichlet=False, algo=algo,
                                    gen_step_cap=256, pool_step_cap=256,
                                    **over)
        scene = build(lib)
        if lib.jax:
            fn = j_gen if algo == "gen" else \
                j_pool.estimate_solution_and_gradient_pool
            res = fn(scene, s, jnp.asarray(pts), key, 48)
        else:
            res = t_solver.estimate_solution_and_gradient(
                scene, s, torch.from_numpy(pts), JaxKey(key), 48)
        out[name] = [to_np(a) for a in res]
    (pt, gt, nt), (pj, gj, nj) = out["torch"], out["jax"]
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(pt, pj, **P_TOL)
    np.testing.assert_allclose(gt, gj, **G_TOL)


@pytest.mark.parametrize("what", ["barrier", "neumann", "dirichlet"])
def test_gen_matches_pool_with_boundary_data(what):
    """The oracle ROADMAP queue 3, item 4 asks for: the port's gen against
    its pool on the same streams where JAX's gen has no unit test
    (double-sided walks, nonzero Neumann data) and with Dirichlet data:
    equal valid counts, tests/test_gen.py's tolerances (the warmup 16 is
    a multiple of gen_group_pairs 4)."""
    lib = LIBS["torch"]
    scene = {"barrier": lambda: barrier_scene(lib, ds_data=True),
             "neumann": lambda: mixed_scene(lib, neumann_data=True),
             "dirichlet": lambda: mixed_scene(lib)}[what]()
    pts = torch.from_numpy(PTS_D)
    out = {}
    for algo in ("gen", "pool"):
        s = t_solver.WalkSettings(ignore_dirichlet=False, algo=algo,
                                  solve_double_sided=what == "barrier",
                                  gen_step_cap=256, pool_step_cap=256)
        out[algo] = [to_np(a) for a in t_solver.estimate_solution_and_gradient(
            scene, s, pts, Key(4), 64)]
    (pg, gg, ng), (pp, gp, np_) = out["gen"], out["pool"]
    np.testing.assert_array_equal(ng, np_)
    np.testing.assert_allclose(pp, pg, **P_TOL)
    np.testing.assert_allclose(gp, gg, **G_TOL)


@pytest.mark.parametrize("algo", ["gen", "pool"])
def test_gradient_executors_manufactured(algo):
    """tests/test_dirichlet.py::test_dirichlet_gradient_both_executors and
    test_doublesided.py's gradient on the port alone, gen and pool, at
    the JAX tests' atol (p 0.06 and 0.08, grad 0.15 and 0.2) with 10,000
    walks: the barrier's gradient has a heavy tail, and over keys 0-11 it
    read 102% of its atol at the JAX tests' 3000 and 98% at 5000
    (port_key_audit.py); generations of 2048 pairs and pools of 2048
    slots only reorder the work."""
    lib = LIBS["torch"]
    gx = lambda x: np.where(x < M, -KL * CL * np.sin(KL * x),
                            KR * CR * np.sin(KR * (L - x)))
    bpts = np.asarray([[0.4, 1.0], [1.3, 0.9]], np.float32)
    s = t_solver.WalkSettings(ignore_dirichlet=False, algo=algo,
                              gen_group_pairs=2048, pool_slots=2048,
                              gen_step_cap=256, pool_step_cap=256)
    pts = torch.from_numpy(PTS_D)
    p, g, n = t_solver.estimate_solution_and_gradient(
        mixed_scene(lib), s, pts, Key(2), 10000)
    mc_close(p, _p_star(lib, pts), 0.06, f"{algo} p")
    want = np.stack([-KX * np.sin(KX * PTS_D[:, 0])
                     * np.cos(KX * PTS_D[:, 1]),
                     -KX * np.cos(KX * PTS_D[:, 0])
                     * np.sin(KX * PTS_D[:, 1])], -1)
    mc_close(g, want, 0.15, f"{algo} grad p")
    assert np.all(to_np(n) > 6666)
    p, g, _ = t_solver.estimate_solution_and_gradient(
        barrier_scene(lib), dataclasses.replace(
            s, solve_double_sided=True), torch.from_numpy(bpts), Key(2),
        10000)
    mc_close(p, _p_barrier(lib, torch.from_numpy(bpts)), 0.08,
             f"{algo} p at the barrier")
    mc_close(g, np.stack([gx(bpts[:, 0]), 0 * bpts[:, 0]], -1), 0.2,
             f"{algo} grad p at the barrier")


# ---------------------------------------------------------------- 3D

def test_harmonic3d_walk_in_the_cube_matches_jax():
    """estimate_solution in the closed cube [-1, 1]^3 with Harmonic3D for
    the first 3 steps of each walk (steps_before_tikhonov, sigma 30
    after), and at sigma = 0, where no walk ends (the harmonic throughput
    never falls below the roulette threshold) and both packages drop
    them all: the same walks, at the walk's tolerances."""
    pts = np.asarray([[0.0, 0.1, -0.2], [0.5, -0.6, 0.3]], np.float32)
    out = {}
    for name, lib in LIBS.items():
        box = (j_a3 if lib.jax else t_a3).make_box3d((-1.0,) * 3, (1.0,) * 3)
        src = lambda x, lib=lib: lib.np.cos(x[..., 0]) * x[..., 2]
        for sigma, over in ((30.0, dict(steps_before_tikhonov=3)),
                            (0.0, {})):
            scene = lib.solver.WostScene(dim=3, neumann=box,
                                         source_fn=src, absorption=sigma)
            s = lib.solver.WalkSettings(walk_step_cap=48, **over)
            out[name, sigma] = [to_np(a) for a in lib.solver.
                                estimate_solution(scene, s, lib.arr(pts),
                                                  lib.key(4), 256)]
    assert t_solver._get_greens(3, 0.0) is t_g3.Harmonic3D
    for sigma in (30.0, 0.0):
        (pt, nt, mt), (pj, nj, mj) = out["torch", sigma], out["jax", sigma]
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_allclose(pt, pj, **P_TOL)
    assert np.all(out["torch", 30.0][1] > 200)
    assert np.all(out["torch", 0.0][1] == 0)


# each setting once refused, and the walks it meets the mixed problem
# with: the JAX tests' 3000, or 5000 for adaptive allocation, whose
# gradient read 96% of its atol at 3000 on a key of keys 0-11
# (port_key_audit.py)
ROUTER_CASES = {
    "lockstep": ([dict(algo="lockstep")], 3000),
    "threefry": ([dict(fast_rng=False)], 3000),
    "adaptive": ([dict(adaptive_walks=1.0),
                  dict(algo="pool", adaptive_walks=1.0)], 5000),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_settings_meet_mixed_problem(case):
    """The settings once refused run through the router and meet the
    mixed problem at the JAX tests' atol (p 0.06, grad 0.15): the lockstep
    gradient (algo "lockstep", and fast_rng=False, which routes there) and
    adaptive allocation, which runs on the pool whether the algo is gen or
    pool (both give the same numbers). With the lockstep case, 3D
    boundary data, once refused, runs on a triangle soup
    (tests/test_torch_mixed3d.py holds it against JAX)."""
    lib = LIBS["torch"]
    scene = mixed_scene(lib)
    pts = torch.from_numpy(PTS_D)
    want = np.stack([-KX * np.sin(KX * PTS_D[:, 0]) * np.cos(KX * PTS_D[:, 1]),
                     -KX * np.cos(KX * PTS_D[:, 0]) * np.sin(KX * PTS_D[:, 1])],
                    -1)
    settings, walks = ROUTER_CASES[case]
    out = []
    for over in settings:
        s = t_solver.WalkSettings(ignore_dirichlet=False, walk_step_cap=256,
                                  pool_step_cap=256, pool_slots=4096, **over)
        p, g, n = t_solver.estimate_solution_and_gradient(scene, s, pts,
                                                          Key(2), walks)
        mc_close(p, _p_star(lib, pts), 0.06, f"p {over}")
        mc_close(g, want, 0.15, f"grad p {over}")
        assert np.all(to_np(n) > walks // 6), over
        out.append((p, g, n))
    if case == "adaptive":
        for a, b in zip(*out):
            assert torch.equal(a, b)
    if case != "lockstep":
        return
    box = build_triangles(*box_tris((-1.0,) * 3, (1.0,) * 3))
    s3 = t_solver.WostScene(dim=3, neumann=box, absorption=30.0,
                            source_fn=lambda x: x[..., 0],
                            neumann_fn=lambda x: x[..., 0])
    p, n, _ = t_solver.estimate_solution(s3, t_solver.WalkSettings(),
                                         torch.zeros(2, 3), Key(0), 8)
    assert bool(torch.isfinite(p).all()) and bool((n > 0).all())
