"""3D boundary data on triangle soups: the port's walks against the JAX
package's and against manufactured solutions, on the CPU.

The problems are the JAX tests' own: tests/test_wost.py:86-112 (the box
[0, L]^3 as a soup, pure Neumann, sigma 30), all of tests/test_mixed3d.py
(Neumann x/y walls and Dirichlet z walls, sigma 5; the double-sided
barrier plane x = M, sigma 10) and tests/test_neumann_data.py:83-100
(nonzero flux through the z = L wall, sigma 30). Both packages take the
same draws (the JAX-replay key for jax.random, fastrand for the walks'
streams) under estimate_solution and both gradient executors, gen and
pool; a walk on a soup may take another path where a rounding error
decides a silhouette or a ray test (XLA contracts some products into
FMAs), so the estimates are held with walk_close: nine points in ten at
tests/test_gen.py's tolerances (p rtol 2e-4 / atol 2e-5, grad rtol 2e-3 /
atol 2e-4), the rest within the walk's noise. The port alone meets the
manufactured solutions at the JAX tests' sizes (3000 walks) and atol,
the gradient on the generation executor with 1024 pairs a generation
(which only reorders the work).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (JaxKey, mc_below, mc_close, spread, to_np,
                           walk_close)

from nmcfluid import geometry as j_geom
from nmcfluid.wost import solver as j_solver
from nmcfluid.wost.gen import estimate_solution_and_gradient_gen as j_gen
from nmcfluid.wost.pool import estimate_solution_and_gradient_pool as j_pool

from nmcfluid_torch import geometry as t_geom
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost import solver as t_solver

L = 2.0
KX = math.pi / L
P_TOL = dict(rtol=2e-4, atol=2e-5)
G_TOL = dict(rtol=2e-3, atol=2e-4)


class _Lib:
    """The pieces of one package the scenes below are built from."""

    def __init__(self, name):
        self.jax = name == "jax"
        self.np = jnp if self.jax else torch
        self.geom = j_geom if self.jax else t_geom
        self.solver = j_solver if self.jax else t_solver

    def arr(self, a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(a) if self.jax else torch.from_numpy(a.copy())

    def where(self, c, a, b):
        return (jnp if self.jax else torch).where(c, a, b)

    def key(self, seed):
        k = jax.random.PRNGKey(seed)
        return k if self.jax else JaxKey(k)


LIBS = {n: _Lib(n) for n in ("jax", "torch")}


def _walls(lib, *axes, extra=()):
    """A soup of the box's walls normal to `axes` (box_tris order: z walls
    0-3, y walls 4-7, x walls 8-11), plus `extra` faces over the box's
    vertices and the barrier's four."""
    v, f = lib.geom.box_tris((0.0, 0.0, 0.0), (L, L, L))
    v = np.concatenate([v, [[M, 0.0, 0.0], [M, L, 0.0], [M, L, L],
                            [M, 0.0, L]]])
    sel = {2: f[0:4], 1: f[4:8], 0: f[8:12]}
    faces = [sel[a] for a in axes] + [np.asarray(extra, np.int64).reshape(
        -1, 3)]
    return lib.geom.build_triangles(v, np.concatenate(faces))


def box_scene(lib, sig=30.0):
    """tests/test_wost.py:86-112: p* = cos cos cos on the closed box."""
    def p(x):
        return (lib.np.cos(KX * x[..., 0]) * lib.np.cos(KX * x[..., 1])
                * lib.np.cos(KX * x[..., 2]))
    return lib.solver.WostScene(
        dim=3, neumann=_walls(lib, 0, 1, 2), absorption=sig,
        source_fn=lambda x: (sig + 3.0 * KX ** 2) * p(x)), p


def mixed_scene(lib, sig=5.0, flux=False):
    """tests/test_mixed3d.py: Neumann x/y walls, Dirichlet z walls,
    p* = cos(KX x) cos(KX z); with flux, a nonzero flux on the Neumann
    walls (the walk's boundary term then runs; p* no longer holds)."""
    def p(x):
        return lib.np.cos(KX * x[..., 0]) * lib.np.cos(KX * x[..., 2])
    h = (lambda x: 0.3 * lib.np.sin(KX * x[..., 1])) if flux else None
    return lib.solver.WostScene(
        dim=3, neumann=_walls(lib, 0, 1), absorption=sig,
        source_fn=lambda x: (sig + 2.0 * KX ** 2) * p(x),
        dirichlet=_walls(lib, 2), dirichlet_fn=p, neumann_fn=h), p


M, SIG_B, CL, CR = 0.8, 10.0, 1.0, 2.0
KL, KR = math.pi / M, math.pi / (L - M)


def barrier_scene(lib, ds_data=False):
    """tests/test_mixed3d.py's double-sided barrier: Neumann y/z walls and
    the plane x = M (normal +x), Dirichlet x walls with the two-strip
    truth; with ds_data, side-dependent boundary data (the aligned flag
    and the terminal side; p* no longer holds)."""
    def p(x):
        xx = x[..., 0]
        return lib.where(xx < M, CL * lib.np.cos(KL * xx),
                         CR * lib.np.cos(KR * (L - xx)))

    def src(x):
        xx = x[..., 0]
        return lib.where(xx < M, (SIG_B + KL ** 2) * CL * lib.np.cos(KL * xx),
                         (SIG_B + KR ** 2) * CR * lib.np.cos(KR * (L - xx)))
    kw = {}
    if ds_data:
        kw = dict(neumann_ds_fn=lambda x, al: lib.where(al, 0.3, -0.2)
                  * lib.np.cos(x[..., 1]),
                  dirichlet_ds_fn=lambda x, side: p(x)
                  + lib.where(side, 0.1, 0.0))
    return lib.solver.WostScene(
        dim=3, neumann=_walls(lib, 1, 2, extra=[[8, 9, 10], [8, 10, 11]]),
        source_fn=src, absorption=SIG_B, dirichlet=_walls(lib, 0),
        dirichlet_fn=p, **kw), p


K_N, SIG_N = math.pi / (2.0 * L), 30.0


def neumann_scene(lib):
    """tests/test_neumann_data.py:83-100: p* = cos(K z), flux -K sin(K L)
    through the z = L wall only."""
    def p(x):
        return lib.np.cos(K_N * x[..., 2])

    def h(x):
        return lib.where(x[..., 2] > L - 1e-4,
                         -K_N * lib.np.sin(K_N * x[..., 2]), 0.0)
    return lib.solver.WostScene(
        dim=3, neumann=_walls(lib, 0, 1, 2), absorption=SIG_N,
        source_fn=lambda x: (SIG_N + K_N ** 2) * p(x), neumann_fn=h), p


# scene, settings, the JAX tests' points and atol of the solution walk
# and of the gen gradient (p, grad p), their walk step cap
CASES = {
    "box": (box_scene, {}, [[1.0, 1.0, 1.0], [0.5, 0.7, 1.3]], 0.05,
            None, 0.15, 96),
    "mixed": (mixed_scene, dict(ignore_dirichlet=False),
              [[1.0, 1.0, 0.4], [0.5, 0.7, 1.6], [1.5, 1.4, 1.0]], 0.06,
              0.07, 0.17, 256),
    "barrier": (barrier_scene, dict(ignore_dirichlet=False,
                                    solve_double_sided=True),
                [[0.3, 1.0, 1.0], [0.55, 0.5, 1.3], [1.1, 1.0, 1.0],
                 [1.6, 1.4, 0.6]], 0.1, 0.1, 0.3, 256),
    "neumann": (neumann_scene, dict(ignore_neumann=False),
                [[1.0, 1.0, 1.0], [0.6, 1.3, 1.8], [1.4, 0.5, 0.4]], 0.07,
                None, 0.15, 96),
}
GRAD_PTS = {"barrier": [[0.4, 1.0, 1.0], [1.3, 0.9, 1.1]]}
# generations of 1024 pairs: the same walks in fewer, wider steps
WIDE = dict(gen_group_pairs=1024)
# the own-key checks' walks, the JAX tests' 3000 where no reading over
# keys 0-11 under the port's key, its 32-bit predecessor or the JAX-replay
# key took more than 80% of a tolerance (port_key_audit.py, CHANGES.md)
SOLUTION_WALKS = {"neumann": 12000}
GRADIENT_WALKS = {"mixed": 4000, "barrier": 6000, "neumann": 32000}


def _settings(lib, case, **over):
    _, kw, _, _, _, _, cap = CASES[case]
    return lib.solver.WalkSettings(walk_step_cap=cap, **kw, **over)


def _grad_truth(case, x):
    """The manufactured gradient at x (numpy)."""
    x = np.asarray(x, np.float64)
    zero = 0.0 * x[:, 0]
    if case == "barrier":
        xx = x[:, 0]
        gx = np.where(xx < M, -KL * CL * np.sin(KL * xx),
                      KR * CR * np.sin(KR * (L - xx)))
        return np.stack([gx, zero, zero], -1)
    if case == "mixed":
        return np.stack([-KX * np.sin(KX * x[:, 0]) * np.cos(KX * x[:, 2]),
                         zero,
                         -KX * np.cos(KX * x[:, 0]) * np.sin(KX * x[:, 2])],
                        -1)
    if case == "neumann":
        return np.stack([zero, zero, -K_N * np.sin(K_N * x[:, 2])], -1)
    c, s = np.cos(KX * x), np.sin(KX * x)
    return -KX * np.stack([s[:, 0] * c[:, 1] * c[:, 2],
                           c[:, 0] * s[:, 1] * c[:, 2],
                           c[:, 0] * c[:, 1] * s[:, 2]], -1)


# ------------------------------------------------ against the JAX package

# the walks' parity problem: the double-sided barrier with its Dirichlet
# walls and a flux through the y and z walls (zero on the barrier), so
# one scene runs the double-sided walk, the terminal fold and the
# boundary term (the JAX package compiles a walk program per scene
# object and executor). The flux is zero on the barrier: a walker on the
# barrier drawing its boundary sample on the barrier's own plane casts a
# visibility ray that grazes the plane, where a rounding error decides
# (test_advance_matches_jax). Walks past 256 steps are dropped in both
# packages (gen_step_cap, pool_step_cap), which bounds the long tail.
PARITY_SETTINGS = dict(ignore_dirichlet=False, solve_double_sided=True,
                       gen_step_cap=256, pool_step_cap=256)


def parity_scene(lib):
    def h(x):
        return lib.where(lib.np.abs(x[..., 0] - M) < 1e-4, 0.0,
                         0.3 * lib.np.sin(KX * x[..., 1] + x[..., 2]))
    return dataclasses.replace(barrier_scene(lib)[0], neumann_fn=h)


@pytest.fixture(scope="module")
def parity_scenes():
    return {name: parity_scene(lib) for name, lib in LIBS.items()}


def _parity_pts():
    """8 points inside the box, away from the barrier."""
    x = np.random.default_rng(3).uniform(0.15, L - 0.15, (8, 3))
    x[:, 0] = np.where(np.abs(x[:, 0] - M) < 0.1, x[:, 0] + 0.2, x[:, 0])
    return x.astype(np.float32)


def _fixed_state(lib, n=512):
    """Walker states in the box from one numpy seed: half on the barrier
    x = M from either side (normals toward the walker's side, flipped on
    some), half inside; mixed step counts, throughputs and sums."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0.05, L - 0.05, (n, 3)).astype(np.float32)
    nrm = np.zeros((n, 3), np.float32)
    k = n // 2
    x[:k, 0] = M
    nrm[:k, 0] = -(rng.integers(0, 2, k) * 2 - 1)
    on = np.arange(n) < k
    fields = dict(x=x, n=nrm, on_neumann=on,
                  thr=rng.uniform(0.5, 1.5, n).astype(np.float32),
                  acc=rng.normal(size=n).astype(np.float32),
                  steps=rng.integers(0, 6, n),
                  status=np.where(rng.uniform(size=n) < 0.1, 1, 0),
                  first_radius=np.zeros(n, np.float32),
                  flipped=on & (rng.uniform(size=n) < 0.5))
    if lib.jax:
        fields = {k_: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                                  else v) for k_, v in fields.items()}
    else:
        fields = {k_: torch.from_numpy(v) for k_, v in fields.items()}
    return lib.solver.WalkState(**fields)


@pytest.mark.parametrize("case", ["mixed", "barrier"])
def test_advance_matches_jax(case):
    """One `_advance` step of every lane of _fixed_state on the same draws
    (one numpy seed a salt), with boundary data on the triangle soups:
    the mixed problem's Dirichlet termination and flux, and the barrier's
    double-sided walk with side-dependent data (the aligned flag, the
    front-face flip): positions, normals and throughputs at rtol 1e-5,
    the sums at the walk's p tolerance, the flags and codes equal. The
    sums may part only where a walker on the barrier drew its boundary
    sample on the barrier's own plane: there the visibility ray grazes
    the plane and XLA's fused arithmetic decides otherwise (JAX's eager
    _advance gives the port's numbers on those lanes too)."""
    out = {}
    for name, lib in LIBS.items():
        if case == "mixed":
            scene = mixed_scene(lib, flux=True)[0]
            s = lib.solver.WalkSettings(ignore_dirichlet=False)
        else:
            scene = barrier_scene(lib, ds_data=True)[0]
            s = lib.solver.WalkSettings(ignore_dirichlet=False,
                                        solve_double_sided=True)

        def draw(salt, shape, lib=lib):
            return lib.arr(np.random.default_rng(100 + salt).uniform(
                size=shape))

        def step(st, scene=scene, s=s, lib=lib, draw=draw):
            return lib.solver._advance(scene, scene.greens(), s, st, draw)
        out[name] = (jax.jit(step) if lib.jax else step)(_fixed_state(lib))
    j, t = out["jax"], out["torch"]
    for f in ("on_neumann", "steps", "status", "flipped"):
        np.testing.assert_array_equal(to_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("x", "n", "thr"):
        np.testing.assert_allclose(to_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    ta, ja = to_np(t.acc), np.asarray(j.acc)
    part = ~(np.abs(ta - ja) <= P_TOL["atol"] + P_TOL["rtol"] * np.abs(ja))
    if case == "barrier":
        assert np.asarray(j.flipped).any()
        lib = LIBS["torch"]
        st = _fixed_state(lib)
        u = [lib.arr(np.random.default_rng(100 + salt).uniform(size=512))
             for salt in (6, 7, 8)]
        bpt, _, _ = t_solver._sample_neumann_boundary(
            barrier_scene(lib)[0], st.x, u[0], torch.stack(u[1:], -1))
        grazing = to_np(st.on_neumann) & (np.abs(to_np(bpt)[:, 0] - M)
                                          < 1e-6)
        assert not np.any(part & ~grazing) and part.mean() < 0.05
    else:
        assert not part.any()


def test_solution_matches_jax(parity_scenes):
    """estimate_solution (128 walks) in both packages on the same keys:
    equal valid counts in nine points in ten, p with walk_close."""
    pts = _parity_pts()
    out = {}
    for name, lib in LIBS.items():
        s = lib.solver.WalkSettings(walk_step_cap=256, **PARITY_SETTINGS)
        out[name] = [to_np(a) for a in lib.solver.estimate_solution(
            parity_scenes[name], s, lib.arr(pts), lib.key(1), 128)]
        if not lib.jax:
            other = to_np(t_solver.estimate_solution(
                parity_scenes[name], s, lib.arr(pts), lib.key(2), 128)[0])
    (pt, nt, _), (pj, nj, _) = out["torch"], out["jax"]
    assert np.mean(nt == nj) >= 0.9
    walk_close(pt, pj, spread(pt, other), **P_TOL)


@pytest.mark.parametrize("algo", ["gen", "pool"])
def test_gradient_matches_jax(parity_scenes, algo):
    """The gradient executor `algo` (32 walks, one generation of 16
    pairs) in both packages on the same key: p and grad p with
    walk_close, against the spread of a second key."""
    pts = _parity_pts()
    out = {}
    for name, lib in LIBS.items():
        s = lib.solver.WalkSettings(algo=algo, gen_group_pairs=16,
                                    **PARITY_SETTINGS)
        scene = parity_scenes[name]
        if lib.jax:
            fn = j_gen if algo == "gen" else j_pool
            out[name] = [np.asarray(a) for a in fn(
                scene, s, jnp.asarray(pts), lib.key(4), 32)[:2]]
        else:
            out[name] = [to_np(a) for a in
                         t_solver.estimate_solution_and_gradient(
                             scene, s, lib.arr(pts), lib.key(4), 32)[:2]]
            other = [to_np(a) for a in
                     t_solver.estimate_solution_and_gradient(
                         scene, s, lib.arr(pts), lib.key(5), 32)[:2]]
    for got, want, o, tol in zip(out["torch"], out["jax"], other,
                                 (P_TOL, G_TOL)):
        walk_close(got, want, spread(got, o), **tol)


# ------------------------------------------- the manufactured solutions

@pytest.mark.parametrize("case", sorted(CASES))
def test_manufactured_solution(case):
    """The port alone at the JAX tests' sizes: estimate_solution (3000
    walks; 12,000 for the flux, whose comparison at one point is noisier)
    at their atol. Dropping the terminal fold moves the mixed
    estimate by more than 0.1, dropping the double-sided walk next to the
    barrier by more than 0.3 (tests/test_mixed3d.py), and dropping the
    flux moves the point near z = L away from p* (tests/
    test_neumann_data.py:83-112)."""
    build, kw, pts, atol, _, _, _ = CASES[case]
    lib = LIBS["torch"]
    scene, p_star = build(lib)
    s = _settings(lib, case)
    x = torch.tensor(pts)
    walks = SOLUTION_WALKS.get(case, 3000)
    p, n, _ = t_solver.estimate_solution(scene, s, x, Key(0), walks)
    mc_close(p, p_star(x), atol, "p")
    assert np.all(to_np(n) > 2 * walks // 3)
    if case == "mixed":
        p0, _, _ = t_solver.estimate_solution(
            scene, dataclasses.replace(s, ignore_dirichlet=True), x, Key(0),
            walks)
        mc_below(0.1, (p0 - p).abs().max(), "the terminal fold moves p")
    if case == "neumann":
        p0, _, _ = t_solver.estimate_solution(
            scene, dataclasses.replace(s, ignore_neumann=True), x, Key(0),
            walks)
        truth = float(p_star(x)[1])
        mc_below(0.015, abs(float(p0[1] - p[1])), "the flux moves p")
        mc_below(abs(float(p[1]) - truth), abs(float(p0[1]) - truth),
                 "the flux's error below the flux-free error")
    if case == "barrier":
        near = torch.tensor([[0.95, 1.0, 1.0], [1.0, 0.6, 1.2]])
        p_ds, _, _ = t_solver.estimate_solution(scene, s, near, Key(4), 3000)
        p_ss, _, _ = t_solver.estimate_solution(
            scene, dataclasses.replace(s, solve_double_sided=False), near,
            Key(4), 3000)
        mc_close(p_ds, p_star(near), 0.15, "p near the barrier")
        mc_below(0.3, (p_ss - p_ds).abs().max(),
                 "the double-sided walk moves p")


@pytest.mark.parametrize("case", sorted(CASES))
def test_manufactured_gradient(case):
    """The gen gradient alone (GRADIENT_WALKS, else 3000 walks): p and
    grad p at tests/test_mixed3d.py's atol, tests/test_wost.py:107-112's
    x component in the box, and test_neumann_data.py's 3D flux carried
    by the boundary term (the pool is held to JAX's pool above, on the
    same streams)."""
    build, _, pts, atol_s, atol_p, atol_g, _ = CASES[case]
    lib = LIBS["torch"]
    scene, p_star = build(lib)
    x = torch.tensor(GRAD_PTS.get(case, pts))
    walks = GRADIENT_WALKS.get(case, 3000)
    p, g, n = t_solver.estimate_solution_and_gradient(
        scene, _settings(lib, case, **WIDE), x, Key(2), walks)
    want = _grad_truth(case, to_np(x))
    mc_close(p, p_star(x), atol_p or atol_s, "p")
    if case == "box":
        mc_close(to_np(g)[:, 0], want[:, 0], atol_g, "d p / d x")
    else:
        mc_close(g, want, atol_g, "grad p")
    assert np.all(to_np(n) > 2 * walks // 3)
