"""The fresh-batch phase fit (`_adam_fit_single`, fit_mode="xla") of the
port against the JAX package's, on the CPU, through the JAX-replay key:
each knob (grad_clip, param_ema, fit_plateau, loss_trace, the cosine and
tail lr schedules), an early stop that fires, ls_head 0 and 8,
fit_ensemble 2 (`_adam_fit`), and the relu, elu and tanh nets with their initializations (normal std 0.1 in 2D,
1.0 in 3D). Tiny nets: 2 hidden layers of 16, 64-point batches, 30 to 70
iterations of the source fit.

Tolerances: parameters rtol 2e-4 / atol 2e-6, the shallow nets'
tolerance of the fused fit against its twin (tests/test_fitkernel.py:
54-131), but the head after ls_head rtol 1e-3 / atol 1e-4, the head
solve's own tolerance (tests/test_torch_fitkernel.py::
test_ls_head_solve_matches_jax: both packages solve the f32 normal
equations by eigendecomposition); the iteration count and the trace
length exactly; the final loss and the trace rtol 1e-5 (the two packages
sum the same batch in another order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, params_np

import nmcfluid.sim.fluid as jfluid
import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid_torch.models.siren import params_from_numpy
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import fitkernel

NET = dict(num_hidden_layers=2, hidden_features=16)
SIZES = dict(sample_resolution=8, wost_resolution=8, div_resolution=8,
             n_walks=8)


def _fluids(scene, over, kw):
    j = jfluid.NeuralFluid(dataclasses.replace(j_get_scene(scene), **over),
                           fit_mode="xla", **SIZES, **kw)
    t = tfluid.NeuralFluid(dataclasses.replace(t_get_scene(scene), **over),
                           fit_mode="xla", device="cpu", **SIZES, **kw)
    return j, t


def _fit_both(scene, over, kw):
    """The source fit from the JAX package's initial params of seed 0, on
    the key PRNGKey(5), in both packages."""
    jf, tf = _fluids(scene, over, kw)
    js = jf.init_state(0)
    ts = tf.init_state(key=JaxKey.from_seed(0))
    for a, b in zip(params_np(ts.params), params_np(js.params)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    key = jax.random.PRNGKey(5)
    pj, sj = jfluid._fit_source(jf, js.params, key, jf.scene.bdry_eps, 0)
    pt, st = tfluid._fit_source(tf, params_from_numpy(js.params),
                                JaxKey(key), tf.scene.bdry_eps, 0)
    return pj, sj, pt, st


CASES = {
    "plain": ("taylorgreen", {}, dict(ls_head=0, max_n_iters=30)),
    "ls_head8": ("taylorgreen", {}, dict(ls_head=8, max_n_iters=30)),
    "grad_clip": ("taylorgreen", dict(lr=1e-3),
                  dict(grad_clip=0.05, ls_head=0, max_n_iters=30)),
    "param_ema": ("taylorgreen", dict(lr=1e-3),
                  dict(param_ema=0.9, ls_head=0, max_n_iters=30)),
    "fit_plateau_trace": ("taylorgreen", dict(lr=1e-3),
                          dict(fit_plateau=5, loss_trace=3, ls_head=0,
                               max_n_iters=30)),
    "loss_trace": ("taylorgreen", dict(lr=1e-3),
                   dict(loss_trace=4, ls_head=8, max_n_iters=30)),
    "cosine": ("taylorgreen", dict(lr=1e-3),
               dict(lr_schedule="cosine", ls_head=0, max_n_iters=30)),
    "tail": ("taylorgreen", dict(lr=1e-3),
             dict(lr_schedule="tail", ls_head=0, max_n_iters=30)),
    # the loss crosses 0.2530 near iteration 14: the loop stops, then
    # leaves at the next stop check
    "early_stop": ("taylorgreen", dict(lr=1e-3, early_stop_loss=0.2530),
                   dict(loss_trace=1, ls_head=0, max_n_iters=70)),
    # two fits from one start on key.fold_in(0x5EED + j), averaged
    # (JAX's _adam_fit): the stats' iters of the first, the mean loss
    "ensemble2": ("taylorgreen", {}, dict(fit_ensemble=2, ls_head=0,
                                          max_n_iters=30)),
    "relu2d": ("taylorgreen", dict(nonlinearity="relu"),
               dict(ls_head=0, max_n_iters=30)),
    # ls_head 0: on this elu net two eigenvalues of the head's normal
    # matrix lie within 4% of the solve's 1e-5 relative cutoff, where the
    # f32 summation order decides their side in either package
    "elu2d": ("taylorgreen", dict(nonlinearity="elu"),
              dict(ls_head=0, max_n_iters=30)),
    "tanh2d": ("taylorgreen", dict(nonlinearity="tanh"),
               dict(ls_head=0, max_n_iters=30)),
    "relu3d": ("smoke", dict(nonlinearity="relu"),
               dict(ls_head=0, max_n_iters=30)),
    "elu3d": ("smoke", dict(nonlinearity="elu"),
              dict(ls_head=0, max_n_iters=30)),
    "tanh3d": ("smoke", dict(nonlinearity="tanh", lr=1e-3),
               dict(grad_clip=1.0, param_ema=0.9, loss_trace=5, ls_head=8,
                    max_n_iters=30)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fresh_batch_fit_matches_jax(case):
    scene, over, kw = CASES[case]
    pj, sj, pt, st = _fit_both(scene, dict(NET, **over), kw)
    assert st.executor == "fresh-batch"
    assert st.iters == int(sj.iters)
    if case == "early_stop":
        assert 1 < st.iters < 32
    elif case == "fit_plateau_trace":
        assert st.iters < kw["max_n_iters"]
    else:
        assert st.iters == kw["max_n_iters"]
    np.testing.assert_allclose(float(st.loss), float(sj.loss), rtol=1e-5)
    leaves_t, leaves_j = params_np(pt), params_np(pj)
    head = 2 if kw["ls_head"] else 0
    for a, b in zip(leaves_t[:len(leaves_t) - head], leaves_j):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
    for a, b in zip(leaves_t[len(leaves_t) - head:], leaves_j[-2:]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    if kw.get("loss_trace"):
        assert st.trace.shape == sj.trace.shape
        np.testing.assert_allclose(st.trace.numpy(), np.asarray(sj.trace),
                                   rtol=1e-5)
    else:
        assert st.trace is None and sj.trace is None


DISPATCH = [
    ("taylorgreen", {}, {}),
    ("taylorgreen", {}, dict(fit_mode="xla")),
    ("taylorgreen", {}, dict(param_ema=0.99)),
    ("taylorgreen", {}, dict(fit_plateau=100)),
    ("taylorgreen", {}, dict(grad_clip=1.0)),
    ("taylorgreen", {}, dict(loss_trace=50)),
    ("taylorgreen", {}, dict(lr_schedule="tail", ls_head=0)),
    ("smoke", dict(nonlinearity="tanh"), {}),
    ("karman", dict(nonlinearity="relu"), dict(fit_mode="fused")),
]


@pytest.mark.parametrize("i", range(len(DISPATCH)))
def test_fresh_batch_runs_where_jax_runs_it(i):
    """The fused fit runs exactly where the JAX package's would on its
    accelerator (fit_mode "auto" is "fused" there), else the fresh-batch
    loop."""
    scene, over, kw = DISPATCH[i]
    mode = kw.pop("fit_mode", "auto")
    j = jfluid.NeuralFluid(dataclasses.replace(j_get_scene(scene), **over),
                           fit_mode="fused" if mode == "auto" else mode,
                           **kw)
    t = tfluid.NeuralFluid(dataclasses.replace(t_get_scene(scene), **over),
                           fit_mode=mode, device="cpu", **kw)
    jax_fused = j.fit_mode == "fused" and jfluid._fused_supported(j)
    assert t.fit_mode == j.fit_mode
    assert tfluid._fused_supported(t) == jfluid._fused_supported(j)
    fused = t.fit_mode == "fused" and tfluid._fused_supported(t)
    assert fused == jax_fused


def test_fused_fit_refuses_non_sine_nets():
    """The fused fit (kernel and CPU twin) takes sine nets only; the
    others reach the fresh-batch loop through _fused_supported."""
    tf = tfluid.NeuralFluid(dataclasses.replace(
        t_get_scene("taylorgreen"), nonlinearity="tanh", **NET),
        device="cpu", **SIZES)
    params = tf.init_state(0).params
    pool = tuple(torch.zeros(s) for s in
                 [(2, 4, 2), (2, 4, 2, 2), (2, 4, 2), (2, 4, 2), (2, 4)])
    with pytest.raises(NotImplementedError, match="tanh"):
        fitkernel.fused_adam_fit(params, tf.siren_cfg, pool, 3, 1e-3)


def test_fit_ensemble_averages_folded_fits():
    """fit_ensemble 2 on the fused fit (its plain twin on the CPU), the
    contract of tests/test_sim.py:146-150: the ensemble's parameters are
    the mean of the two single fits on key.fold_in(0x5EED + j), leaf by
    leaf, and differ from either; its stats carry the single fit's
    executor and iterations and the mean loss."""
    tf = tfluid.NeuralFluid(dataclasses.replace(t_get_scene("taylorgreen"),
                                                **NET),
                            device="cpu", max_n_iters=20, fit_pool=4,
                            fit_ensemble=2, **SIZES)
    state = tf.init_state(0)
    batches = tfluid._SourceBatches(tf, tf.scene.bdry_eps, 0)
    key = JaxKey.from_seed(3)
    with torch.no_grad():
        pe, se = tfluid._adam_fit(tf, state.params, key, batches)
        singles = [tfluid._adam_fit_single(tf, state.params,
                                           key.fold_in(0x5EED + j), batches)
                   for j in range(2)]
    (p1, s1), (p2, s2) = singles
    for e, a, b in zip(params_np(pe), params_np(p1), params_np(p2)):
        np.testing.assert_array_equal(e, (a + b) / 2.0)
        assert not np.array_equal(e, a)
    assert se.executor == s1.executor == "plain twin"
    assert se.iters == s1.iters == 20
    np.testing.assert_allclose(float(se.loss),
                               (float(s1.loss) + float(s2.loss)) / 2,
                               rtol=1e-6)
