"""The port's spectral projection against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through both packages: the
orthonormal DCT built from torch.fft against jax.scipy.fft.dct/idct, the
screened-Poisson solve and grid_gradient (2D 48 x 40 and 3D 12^3, sigma
350 and 0), bilinear_lookup, the circle (karman), cylinder (karman3d)
and sphere (smoke_obs) corrections' fits and evaluations, the spectral
pressure solve of a step on the same key, one chained Taylor-Green step
under projection="spectral", and the refusals.

Tolerances, each against the largest magnitude of the JAX result (atol =
tol * max|ref|) unless a test says otherwise: the two packages run the
same float32 formulas in other orders (an N-point FFT in both, with other
twiddles), and measured at most 6.0e-7 of the magnitude for the DCTs,
4.0e-7 for the solves and gradients, 0 for bilinear_lookup and 3e-6 for
the corrections (the recurrences in the Bessel ratios carry an ulp
through 32 modes); they are held at 1e-5 (bilinear_lookup exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, chained_runs, params_np, to_np

import nmcfluid.sim.fluid as jfluid
import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid.ops import circle_modes as jc
from nmcfluid.ops import cylinder_modes as jcy
from nmcfluid.ops import sphere_modes as jsp
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import sampling as jsam
from nmcfluid.sim import spectral as jspec
from nmcfluid_torch.ops import circle_modes as tc
from nmcfluid_torch.ops import cylinder_modes as tcy
from nmcfluid_torch.ops import sphere_modes as tsp
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import sampling as tsam
from nmcfluid_torch.sim import spectral as tspec

TOL = 1e-5
BOX2 = (-1.0, 1.0, -0.5, 1.2)
CUBE = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)


def close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def box_points(ss, n, seed, margin=0.0):
    d = len(ss) // 2
    lo, hi = np.asarray(ss[0::2]), np.asarray(ss[1::2])
    u = np.random.RandomState(seed).rand(n, d)
    return (lo - margin + u * (hi - lo + 2 * margin)).astype(np.float32)


@pytest.mark.parametrize("shape", [(48, 40), (12, 12, 12)])
def test_dct_matches_jax(shape):
    x = rand(shape, 0)
    for ax in range(len(shape)):
        close(tspec.dct_ortho(torch.tensor(x), ax),
              jax.scipy.fft.dct(jnp.asarray(x), type=2, axis=ax,
                                norm="ortho"))
        close(tspec.idct_ortho(torch.tensor(x), ax),
              jax.scipy.fft.idct(jnp.asarray(x), type=2, axis=ax,
                                 norm="ortho"))


@pytest.mark.parametrize("sigma", [350.0, 0.0])
@pytest.mark.parametrize("shape,ss", [((48, 40), BOX2), ((12, 12, 12), CUBE)])
def test_solve_and_gradient_match_jax(shape, ss, sigma):
    """sigma = 0 takes the branch that pins the k = 0 mode."""
    f = rand(shape, 1)
    pj = jspec.solve_screened_poisson(jnp.asarray(f), ss, sigma)
    pt = tspec.solve_screened_poisson(torch.tensor(f), ss, sigma)
    close(pt, pj)
    close(tspec.grid_gradient(pt, ss), jspec.grid_gradient(pj, ss))
    if sigma == 0.0:
        assert abs(float(pt.double().mean())) < 1e-6


@pytest.mark.parametrize("shape,ss", [((48, 40), BOX2), ((12, 12, 12), CUBE)])
def test_bilinear_lookup_matches_jax(shape, ss):
    """Points up to 0.1 outside the box too (the lookup clamps)."""
    g = rand(shape, 2)
    y = box_points(ss, 500, 3, margin=0.1)
    np.testing.assert_array_equal(
        to_np(tsam.bilinear_lookup(torch.tensor(g), ss, torch.tensor(y))),
        np.asarray(jsam.bilinear_lookup(jnp.asarray(g), ss, jnp.asarray(y))))


def _smooth_gradient(shape, ss, seed):
    """The gradient of a box solve of random data: a smooth g_grid."""
    p = jspec.solve_screened_poisson(jnp.asarray(rand(shape, seed)), ss,
                                     350.0)
    return np.asarray(jspec.grid_gradient(p, ss))


def test_circle_correction_matches_jax():
    """Karman's circle on a 64 x 32 grid over its box: the coefficients
    and (q, grad q) at 2,000 points, inside the circle too."""
    sc = j_get_scene("karman")
    ss, c, r = sc.scene_size, sc.obstacle_center, sc.obstacle_radius
    g = _smooth_gradient((64, 32), ss, 4)
    cj = jc.fit_circle_correction(jnp.asarray(g), ss, c, r, 350.0)
    ct = tc.fit_circle_correction(torch.tensor(g), ss, c, r, 350.0)
    for a, b in zip(ct, cj):
        close(a, b)
    y = box_points(ss, 2000, 5)
    y[:100] = np.asarray(c) + 0.9 * r * (box_points((-1, 1, -1, 1), 100, 6))
    qj, gj = jc.eval_circle_correction(cj, jnp.asarray(y), c, r, 350.0)
    qt, gt = tc.eval_circle_correction(ct, torch.tensor(y), c, r, 350.0)
    close(qt, qj)
    close(gt, gj)


def test_cylinder_correction_matches_jax():
    """karman3d's cylinder along y on a 16^3 grid."""
    sc = j_get_scene("karman3d")
    ss, c, r = sc.scene_size, sc.obstacle_center, sc.obstacle_radius
    g = _smooth_gradient((16, 16, 16), ss, 7)
    cj = jcy.fit_cylinder_correction(jnp.asarray(g), ss, c, r, 350.0)
    ct = tcy.fit_cylinder_correction(torch.tensor(g), ss, c, r, 350.0)
    for a, b in zip(ct, cj):
        close(a, b)
    y = box_points(ss, 2000, 8)
    qj, gj = jcy.eval_cylinder_correction(cj, jnp.asarray(y), ss, c, r,
                                          350.0)
    qt, gt = tcy.eval_cylinder_correction(ct, torch.tensor(y), ss, c, r,
                                          350.0)
    close(qt, qj)
    close(gt, gj)


def test_sphere_correction_matches_jax():
    """smoke_obs's sphere on a 16^3 grid; grad q by autograd of the summed
    field against JAX's per-point jax.grad under vmap."""
    sc = j_get_scene("smoke_obs")
    ss, c, r = sc.scene_size, sc.obstacle_center, sc.obstacle_radius
    g = _smooth_gradient((16, 16, 16), ss, 9)
    cj = jsp.fit_sphere_correction(jnp.asarray(g), ss, c, r, 350.0)
    ct = tsp.fit_sphere_correction(torch.tensor(g), ss, c, r, 350.0)
    close(ct, cj)
    y = box_points(ss, 1000, 10)
    y[:50] = np.asarray(c) + 0.3 * box_points((-1, 1, -1, 1, -1, 1), 50, 11)
    qj, gj = jsp.eval_sphere_correction(cj, jnp.asarray(y), c, r, 350.0)
    qt, gt = tsp.eval_sphere_correction(ct, torch.tensor(y), c, r, 350.0)
    close(qt, qj)
    close(gt, gj)


SOLVE_SIZES = dict(sample_resolution=8, wost_resolution=32, n_walks=48,
                   max_n_iters=20, fit_pool=4)


@pytest.mark.parametrize("name", ["taylorgreen", "karman", "smoke_obs",
                                  "karman3d", "smoke"])
def test_pressure_solve_matches_jax(name):
    """`_pressure_solve_spectral` on one divergence grid and one key: the
    cloud (to an ulp, rtol 2e-7 with atol 2.4e-7 for coordinates near 0:
    XLA may fuse lo + u (hi - lo) into an FMA; measured 6.0e-8 at |x| <
    0.2 on karman's box), its validity, and p and grad p after the
    correction and the masking."""
    div_res = 48 if j_get_scene(name).dim == 2 else 16
    sizes = dict(SOLVE_SIZES, div_resolution=div_res)
    jf = jfluid.NeuralFluid(j_get_scene(name), projection="spectral",
                            **sizes)
    tf = tfluid.NeuralFluid(t_get_scene(name), projection="spectral",
                            device="cpu", **sizes)
    res = tsam.grid_resolutions(tf.scene.scene_size, div_res)
    div = rand(res, 12)
    key = jax.random.PRNGKey(3)
    pts_j, valid_j, p_j, g_j = jfluid._pressure_solve_spectral(
        jf, jnp.asarray(div), key, 1e-2, 1)
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve_spectral(
        tf, torch.tensor(div), JaxKey(key))
    np.testing.assert_allclose(to_np(pts_t), np.asarray(pts_j), rtol=2e-7,
                               atol=2.4e-7)
    np.testing.assert_array_equal(to_np(valid_t), np.asarray(valid_j))
    close(p_t, p_j)
    close(g_t, g_j)


@pytest.fixture(scope="module")
def tg_runs():
    return chained_runs("taylorgreen", dict(
        sample_resolution=8, wost_resolution=16, div_resolution=16,
        n_walks=48, max_n_iters=20, fit_pool=4, projection="spectral"))


def test_tg_step_under_spectral_matches_jax(tg_runs):
    """add_source + one step under projection="spectral": each fit at the
    TG-family fit tolerance of tests/test_torch_step.py (rtol 2e-4 / atol
    1e-3), the same ls_head branches, and the final params and P."""
    jf, js, tf, ts, logs = tg_runs
    assert [n for n, _ in logs["torch"]["fits"]] == [
        "_fit_source", "_fit_advect", "_fit_project"]
    for (_, pj), (_, pt) in zip(logs["jax"]["fits"], logs["torch"]["fits"]):
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-3)
    assert logs["torch"]["branch"] == logs["jax"]["branch"]
    for a, b in zip(params_np(ts.params), params_np(js.params)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(float(ts.P), float(js.P), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["jpipe", "karman2cyl", "karman3cyl"])
def test_spectral_refused_where_jax_refuses(name):
    """The box solve needs the box minus at most one circle: both packages
    raise ValueError with the same message."""
    with pytest.raises(ValueError) as ej:
        jfluid.NeuralFluid(j_get_scene(name), projection="spectral")
    with pytest.raises(ValueError) as et:
        tfluid.NeuralFluid(t_get_scene(name), projection="spectral",
                           device="cpu")
    assert str(et.value) == str(ej.value)
