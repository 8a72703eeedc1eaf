"""The port's BEM projection against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through both packages: the
free-space kernels of wost/bvc.py, the float64 host pieces of sim/bem.py
(the kernels, the closed loops, the equispaced cache, the kernel spectra;
exact, as both run the same numpy), the BemProjector's constants and its
solve on Taylor-Green (128, n_boundary 1024, eval_chunk 1024, the fixture
of tests/test_bem.py), karman, jpipe and karman2cyl at small sizes, the
port's own cache of the Nystrom inverse, the BEM pressure solve of a step
on the same key, one chained Taylor-Green step under projection="bem",
and the refusals.

Tolerances, against the largest magnitude of the JAX result (atol = tol *
max|ref|): the device parts run the same float32 formulas in other
orders (FFT sizes and twiddles, the (B, B) matvec's and the splat's
reduction orders); measured at most 9e-7 of the magnitude for the
kernels, 2e-6 for the potentials and the solve's p, 4e-6 for grad p,
held at 1e-5. The float64 host pieces are held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, chained_runs, params_np, to_np

import nmcfluid.sim.bem as jbem
import nmcfluid.sim.fluid as jfluid
import nmcfluid.wost.bvc as jbvc
import nmcfluid_torch.sim.bem as tbem
import nmcfluid_torch.sim.fluid as tfluid
import nmcfluid_torch.wost.bvc as tbvc
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid_torch.scenes import get_scene as t_get_scene

TOL = 1e-5
SCENES_2D = ["taylorgreen", "karman", "jpipe", "karman2cyl", "karman3cyl"]


def close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def box_points(ss, n, seed):
    lo, hi = np.asarray(ss[0::2]), np.asarray(ss[1::2])
    u = np.random.RandomState(seed).rand(n, len(lo))
    return (lo + u * (hi - lo)).astype(np.float32)


@pytest.mark.parametrize("lam", [350.0, 0.0])
@pytest.mark.parametrize("dim", [2, 3])
def test_free_kernels_match_jax(dim, lam):
    rs = np.random.RandomState(dim)
    d = rs.randn(4000, dim).astype(np.float32) * 0.2
    n = rs.randn(4000, dim)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    r = np.sqrt(np.sum(d.astype(np.float64) ** 2, -1)).astype(np.float32)
    tr = torch.tensor(r)
    for name in ("_free_G", "_free_dGdr"):
        close(getattr(tbvc, name)(dim, lam, tr),
              getattr(jbvc, name)(dim, lam, jnp.asarray(r)))
    close(tbvc._free_dP(dim, lam, torch.tensor(d), tr, torch.tensor(n)),
          jbvc._free_dP(dim, lam, jnp.asarray(d), jnp.asarray(r),
                        jnp.asarray(n)))


def test_host_kernels_are_exact():
    rs = np.random.RandomState(1)
    x, y = rs.randn(50, 2), rs.randn(60, 2)
    n = rs.randn(60, 2)
    r = np.abs(rs.randn(100)) + 1e-3
    np.testing.assert_array_equal(tbem._np_G(350.0, r), jbem._np_G(350.0, r))
    np.testing.assert_array_equal(tbem._np_dGdr(350.0, r),
                                  jbem._np_dGdr(350.0, r))
    np.testing.assert_array_equal(tbem._np_P(350.0, x, y, n),
                                  jbem._np_P(350.0, x, y, n))


@pytest.mark.parametrize("name", SCENES_2D)
def test_loops_and_cache_points_are_exact(name):
    """The closed loops (karman's circle taken once: box + 1 loop) and the
    equispaced midpoint cache, float64, exactly."""
    lj = jbem.closed_loops(j_get_scene(name))
    lt = tbem.closed_loops(t_get_scene(name))
    assert len(lt) == len(lj)
    assert len(lt) == {"taylorgreen": 1, "karman": 2, "jpipe": 1,
                       "karman2cyl": 3, "karman3cyl": 4}[name]
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    for n_total in (1024, 4096):
        for a, b in zip(tbem.equispaced_boundary(lt, n_total),
                        jbem.equispaced_boundary(lj, n_total)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["taylorgreen", "karman"])
def test_kernel_ffts_are_exact(name):
    sc = j_get_scene(name)
    ss = sc.scene_size
    from nmcfluid.sim.sampling import grid_resolutions
    res = grid_resolutions(ss, 128)
    h = ((ss[1] - ss[0]) / res[0], (ss[3] - ss[2]) / res[1])
    *kt, shape_t = tbem._kernel_ffts(res, h, 350.0, 17.0 / np.sqrt(350.0))
    *kj, shape_j = jbem._kernel_ffts(res, h, 350.0, 17.0 / np.sqrt(350.0))
    assert shape_t == shape_j
    for a, b in zip(kt, kj):
        np.testing.assert_array_equal(a, b)
    for n in (7, 129, 1000, 1049, 4097):
        assert tbem._next_fast(n) == jbem._next_fast(n)


def test_vertex_bilerp_matches_jax():
    g = np.random.RandomState(2).randn(49, 33).astype(np.float32)
    ss = (-1.0, 1.0, -0.5, 1.2)
    y = box_points(ss, 1000, 3)
    np.testing.assert_array_equal(
        to_np(tbem._vertex_bilerp(torch.tensor(g), ss, torch.tensor(y))),
        np.asarray(jbem._vertex_bilerp(jnp.asarray(g), ss, jnp.asarray(y))))


# the TG projector of tests/test_bem.py; the others at small sizes
PROJECTORS = {
    "taylorgreen": dict(div_resolution=128, n_boundary=1024,
                        eval_chunk=1024),
    "karman": dict(div_resolution=96, n_boundary=1024, eval_chunk=512),
    "jpipe": dict(div_resolution=64, n_boundary=512, eval_chunk=1024),
    "karman2cyl": dict(div_resolution=96, n_boundary=1024, eval_chunk=700),
}


@pytest.fixture(scope="module")
def projectors(tmp_path_factory):
    out = {}
    for name, kw in PROJECTORS.items():
        kw = dict(kw)
        div = kw.pop("div_resolution")
        cache = tmp_path_factory.mktemp(f"bem_{name}")
        out[name] = (
            jbem.BemProjector(j_get_scene(name), div, cache_dir=str(cache),
                              **kw),
            tbem.BemProjector(t_get_scene(name), div, cache_dir=str(cache),
                              **kw))
    return out


@pytest.mark.parametrize("name", list(PROJECTORS))
def test_projector_constants_match_jax(projectors, name):
    """Sizes, the fluid indicator and the cache exactly; the float64 host
    results after the cast to float32 exactly (the same numpy in both);
    the kernel spectra as complex64 against JAX's (real, imag) pair."""
    bj, bt = projectors[name]
    assert (bt.res, bt.spacing, bt.fft_shape, bt.n_boundary,
            bt.eval_chunk) == (bj.res, bj.spacing, bj.fft_shape,
                               bj.n_boundary, bj.eval_chunk)
    for a in ("chi", "Vc", "gVc", "cache_pts", "cache_n", "cache_w",
              "A_inv"):
        np.testing.assert_array_equal(to_np(getattr(bt, a)),
                                      np.asarray(getattr(bj, a)), err_msg=a)
    for k in ("KGf", "KXf", "KYf"):
        K = getattr(bt, k)
        assert K.dtype == torch.complex64
        ri = np.asarray(getattr(bj, k + "_ri"))
        np.testing.assert_array_equal(K.real.numpy(), ri[0])
        np.testing.assert_array_equal(K.imag.numpy(), ri[1])


@pytest.mark.parametrize("name", list(PROJECTORS))
def test_projector_solve_matches_jax(projectors, name):
    """The volume potentials and (p, grad p) of a random divergence grid
    at 3,000 points of the box (the splat's chunks end unevenly)."""
    bj, bt = projectors[name]
    div = np.random.RandomState(4).randn(*bj.res).astype(np.float32)
    for a, b in zip(tbem._volume_potentials(bt, torch.tensor(div)),
                    jbem._volume_potentials(bj, jnp.asarray(div))):
        close(a, b)
    y = box_points(bj.scene.scene_size, 3000, 5)
    pj, gj = bj.solve(jnp.asarray(div), jnp.asarray(y))
    pt, gt = bt.solve(torch.tensor(div), torch.tensor(y))
    close(pt, pj)
    close(gt, gj)


def test_port_caches_its_own_inverse(tmp_path, monkeypatch):
    """The inverse goes to the port's own file tag and is reused, unless
    the file's cache points or constant potential differ."""
    sc = t_get_scene("taylorgreen")
    kw = dict(n_boundary=256, cache_dir=str(tmp_path))
    first = tbem.BemProjector(sc, 32, **kw)
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["torch_taylorgreen_r32_b256_s350_v1.npz"]

    def no_inverse(a):
        raise AssertionError("rebuilt although cached")
    with monkeypatch.context() as mp:
        mp.setattr(tbem.np.linalg, "inv", no_inverse)
        again = tbem.BemProjector(sc, 32, **kw)
    assert torch.equal(again.A_inv, first.A_inv)
    # a file whose constant potential differs is rebuilt
    with np.load(files[0]) as z:
        np.savez(files[0], A_inv=np.zeros_like(z["A_inv"]), pts=z["pts"],
                 Vc=z["Vc"] + 1.0)
    rebuilt = tbem.BemProjector(sc, 32, **kw)
    assert torch.equal(rebuilt.A_inv, first.A_inv)


SOLVE_SIZES = dict(sample_resolution=8, wost_resolution=32, n_walks=48,
                   max_n_iters=20, fit_pool=4, div_resolution=48)


@pytest.mark.parametrize("name", ["taylorgreen", "karman", "jpipe"])
def test_pressure_solve_matches_jax(name, tmp_path):
    """`_pressure_solve_bem` on one divergence grid and one key: the
    cloud (to an ulp, rtol 2e-7 with atol 2.4e-7 for coordinates near 0:
    XLA may fuse lo + u (hi - lo) into an FMA), its validity, and p and
    grad p after the masking."""
    jf = jfluid.NeuralFluid(j_get_scene(name), projection="bem",
                            **SOLVE_SIZES)
    tf = tfluid.NeuralFluid(t_get_scene(name), projection="bem",
                            device="cpu", **SOLVE_SIZES)
    bj = jbem.BemProjector(jf.scene, 48, cache_dir=str(tmp_path))
    bt = tbem.BemProjector(tf.scene, 48, cache_dir=str(tmp_path))
    div = np.random.RandomState(6).randn(*bj.res).astype(np.float32)
    key = jax.random.PRNGKey(5)
    pts_j, valid_j, p_j, g_j = jfluid._pressure_solve_bem(
        jf, bj, jnp.asarray(div), key)
    pts_t, valid_t, p_t, g_t = tfluid._pressure_solve_bem(
        tf, bt, torch.tensor(div), JaxKey(key))
    np.testing.assert_allclose(to_np(pts_t), np.asarray(pts_j), rtol=2e-7,
                               atol=2.4e-7)
    np.testing.assert_array_equal(to_np(valid_t), np.asarray(valid_j))
    close(p_t, p_j)
    close(g_t, g_j)


@pytest.fixture(scope="module")
def tg_runs():
    return chained_runs("taylorgreen", dict(
        sample_resolution=8, wost_resolution=16, div_resolution=16,
        n_walks=48, max_n_iters=20, fit_pool=4, projection="bem"))


def test_tg_step_under_bem_matches_jax(tg_runs):
    """add_source + one step under projection="bem": each fit at the
    TG-family fit tolerance of tests/test_torch_step.py (rtol 2e-4 / atol
    1e-3), the same ls_head branches, the final params and P."""
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
    assert tf._bem.n_boundary == jf._bem.n_boundary


@pytest.mark.parametrize("name", ["smoke", "karman3d"])
def test_bem_refused_in_3d(name):
    with pytest.raises(ValueError) as ej:
        jfluid.NeuralFluid(j_get_scene(name), projection="bem")
    with pytest.raises(ValueError) as et:
        tfluid.NeuralFluid(t_get_scene(name), projection="bem",
                           device="cpu")
    assert str(et.value) == str(ej.value)


def test_bem_refuses_absorption_zero():
    import dataclasses
    js = dataclasses.replace(j_get_scene("taylorgreen"), absorption=0.0)
    ts = dataclasses.replace(t_get_scene("taylorgreen"), absorption=0.0)
    with pytest.raises(ValueError) as ej:
        jbem.BemProjector(js, 16)
    with pytest.raises(ValueError) as et:
        tbem.BemProjector(ts, 16)
    assert str(et.value) == str(ej.value)
