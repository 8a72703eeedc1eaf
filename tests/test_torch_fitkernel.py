"""The port's phase fit against the JAX package's, on the CPU.

On a CPU tensor the port's `fused_adam_fit` runs its plain twin
`reference_adam_fit`; the CUDA kernel is held against that twin on the
card (chip_smoke.py and tests/test_torch_gpu.py). Here the twin is held
against the JAX package's `reference_adam_fit` (optax) and against its
fused Pallas kernel in interpret mode, with the shape families, pool
cycling and lr-array cases of tests/test_fitkernel.py at its tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, params_np, to_np

from nmcfluid.models.siren import SirenConfig as JCfg, init_siren
from nmcfluid.models.siren import apply_siren_features as j_features
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import NeuralFluid as JFluid
from nmcfluid.sim import fitkernel as jfk
from nmcfluid.sim import fluid as jfluid
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.sim.fluid import _ls_head_solve as j_ls_head

from nmcfluid_torch.models.siren import SirenConfig as TCfg, \
    params_from_numpy
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import fitkernel as tfk
from nmcfluid_torch.sim import fluid as tfluid
from nmcfluid_torch.sim.fluid import NeuralFluid as TFluid, _PhaseBatches
from nmcfluid_torch.sim.fluid import _ls_head_solve as t_ls_head


def make_problem(seed, *, D_in=2, D_out=2, H=64, Lh=2, K=3, B=256):
    """Parameters from the JAX initializer, pool from numpy (the same
    distributions as tests/test_fitkernel.py::make_problem)."""
    jcfg = JCfg(D_in, D_out, num_hidden_layers=Lh, hidden_features=H)
    tcfg = TCfg(D_in, D_out, num_hidden_layers=Lh, hidden_features=H)
    params = [(np.asarray(W), np.asarray(b))
              for W, b in init_siren(jax.random.PRNGKey(seed), jcfg)]
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    pool = (f32(rng.uniform(-1.0, 1.0, (K, B, D_in))),
            f32(rng.normal(size=(K, B, D_out, D_out)) * 0.5),
            f32(rng.normal(size=(K, B, D_out)) * 0.1),
            f32(rng.normal(size=(K, B, D_out)) * 0.2),
            f32(rng.uniform(size=(K, B)) > 0.25))
    return jcfg, tcfg, params, pool


def run_torch(tcfg, params, pool, n_iters, lr):
    p, loss = tfk.fused_adam_fit(
        params_from_numpy(params), tcfg,
        tuple(torch.from_numpy(a) for a in pool), n_iters,
        torch.as_tensor(np.asarray(lr, np.float32)))
    return params_np(p), float(loss)


def run_jax(fn, jcfg, params, pool, n_iters, lr):
    p, loss = fn([(jnp.asarray(W), jnp.asarray(b)) for W, b in params], jcfg,
                 tuple(jnp.asarray(a) for a in pool), n_iters,
                 jnp.asarray(lr, jnp.float32))
    return params_np(p), float(loss)


@pytest.mark.parametrize("shape", [
    # atol: Adam is sign-like while v is tiny, so a last-ulp reassociation
    # difference in a near-zero gradient coordinate moves that parameter
    # by O(lr) for a step; the 6-layer TG net hits this
    # (tests/test_fitkernel.py:45-53)
    dict(D_in=2, D_out=2, H=64, Lh=2, atol=2e-6, seed=0),  # karman/jpipe
    dict(D_in=3, D_out=3, H=64, Lh=3, atol=2e-6, seed=0),  # 3D family
    # The 6-layer net's 25-step trajectory on a random, unrealizable pool
    # is chaotic for some draws: on numpy pool seeds 0 and 1 the JAX
    # package's own reference and interpreted kernel already differ by up
    # to 5e-3. Seed 3 is a draw where those two agree inside the
    # tolerance, so the comparison measures the port, not the chaos.
    dict(D_in=2, D_out=2, H=64, Lh=6, atol=1e-3, seed=3),  # taylorgreen
])
@pytest.mark.parametrize("oracle", ["reference", "fused_interpret"])
def test_twin_matches_jax(shape, oracle):
    shape = dict(shape)
    atol = shape.pop("atol")
    jcfg, tcfg, params, pool = make_problem(shape.pop("seed"), **shape)
    fn = jfk.reference_adam_fit if oracle == "reference" \
        else jfk.fused_adam_fit
    n_iters, lr = 25, 1e-3
    p_j, l_j = run_jax(fn, jcfg, params, pool, n_iters, lr)
    p_t, l_t = run_torch(tcfg, params, pool, n_iters, lr)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=atol)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-2, atol=1e-9)


def test_pool_cycling_order():
    """Batch j = i % K: with batch 1 weightless, every odd iteration is a
    zero-gradient Adam step that still decays the moments; the twin must
    follow the JAX reference through that (test_fitkernel.py:89-104)."""
    jcfg, tcfg, params, pool = make_problem(3, K=2, B=128)
    x, A, c, tgt, w = pool
    w = w.copy()
    w[1] = 0.0
    pool = (x, A, c, tgt, w)
    p_j, _ = run_jax(jfk.reference_adam_fit, jcfg, params, pool, 8, 1e-3)
    p_t, _ = run_torch(tcfg, params, pool, 8, 1e-3)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)


def test_lr_schedule_array():
    """A decaying per-iteration lr array is applied per iteration as in
    the JAX package (test_fitkernel.py:122-136)."""
    jcfg, tcfg, params, pool = make_problem(5)
    n_iters = 12
    lr = 1e-3 * (0.85 ** np.arange(n_iters, dtype=np.float32))
    p_j, _ = run_jax(jfk.reference_adam_fit, jcfg, params, pool, n_iters, lr)
    p_t, _ = run_torch(tcfg, params, pool, n_iters, lr)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
    p_c, _ = run_torch(tcfg, params, pool, n_iters, 1e-3)
    assert max(np.max(np.abs(a - b)) for a, b in zip(p_t, p_c)) > 1e-6


@pytest.mark.parametrize("schedule", ["constant", "cosine", "tail"])
def test_fit_lr_array_matches_jax(schedule):
    """The per-iteration learning rates handed to the fused fit: the same
    optax schedules, evaluated in float32 on both sides."""
    kw = dict(max_n_iters=50, sample_resolution=8, wost_resolution=8,
              div_resolution=8, lr_schedule=schedule)
    want = jfluid._fit_lr_array(JFluid(j_get_scene("taylorgreen"), **kw))
    got = tfluid._fit_lr_array(TFluid(t_get_scene("taylorgreen"),
                                      device="cpu", **kw))
    assert np.shape(to_np(got)) == np.shape(np.asarray(want))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6)


def test_twin_actually_trains():
    """Loss drops by a large factor on a realizable target
    (test_fitkernel.py:66-86)."""
    jcfg, tcfg, params, pool = make_problem(1)
    x, _, _, _, w = pool
    K, B, _ = x.shape
    A = np.broadcast_to(np.eye(2, dtype=np.float32), (K, B, 2, 2)).copy()
    c = np.zeros((K, B, 2), np.float32)
    true = params_from_numpy(
        [(np.asarray(W), np.asarray(b))
         for W, b in init_siren(jax.random.PRNGKey(2), jcfg)])
    from nmcfluid_torch.models.siren import apply_siren
    tgt = apply_siren(true, tcfg, torch.from_numpy(x)).numpy()

    def loss(p):
        u = apply_siren(params_from_numpy(p), tcfg, torch.from_numpy(x))
        se = ((u.numpy() - tgt) ** 2).sum(-1)
        return float((w * se).sum() / w.sum())

    before = loss(params)
    p_t, _ = run_torch(tcfg, params, (x, A, c, tgt, w), 400, 3e-4)
    after = loss([(p_t[2 * i], p_t[2 * i + 1]) for i in range(len(params))])
    assert after < 0.25 * before


def test_cuda_pool_without_kernel_inputs_raises():
    """The CUDA wrapper validates before it builds or launches: a CPU pool
    goes to the twin, bad shapes raise."""
    jcfg, tcfg, params, pool = make_problem(0)
    bad = params_from_numpy(params)[:-1]      # head missing
    with pytest.raises(ValueError):
        tfk._check_cuda_inputs(bad, tcfg,
                               tuple(torch.from_numpy(a) for a in pool))


# ----------------------------------------------------------- ls_head


def _tiny(lib, ls_head):
    if lib == "jax":
        scene = j_get_scene("taylorgreen")
        scene = dataclasses.replace(
            scene, max_n_iters=50, _boundary_builder=scene._boundary_builder,
            _source_builder=scene._source_builder,
            _obstacle_sdf_builder=scene._obstacle_sdf_builder)
        return JFluid(scene, sample_resolution=16, wost_resolution=16,
                      div_resolution=16, ls_head=ls_head)
    return TFluid(t_get_scene("taylorgreen"), max_n_iters=50,
                  sample_resolution=16, wost_resolution=16,
                  div_resolution=16, ls_head=ls_head, device="cpu")


def test_ls_head_solve_matches_jax():
    """Identical inputs (trunk, corrupted head, batches through the
    replayed keys): the solved head agrees and the do-no-harm branch is
    the same. The f32 normal equations are solved by eigendecomposition
    on both sides, so the head agrees to ~1e-4 relative."""
    jf, tf = _tiny("jax", 2), _tiny("torch", 2)
    jcfg = jf.siren_cfg
    true = [(np.asarray(W), np.asarray(b))
            for W, b in init_siren(jax.random.PRNGKey(0), jcfg)]
    rng = np.random.default_rng(5)
    W, b = true[-1]
    bad = true[:-1] + [(W + 0.3 * rng.normal(size=W.shape).astype(np.float32),
                        b + 0.3 * rng.normal(size=b.shape).astype(np.float32))]
    eps = 1e-3
    true_j = [(jnp.asarray(a), jnp.asarray(c)) for a, c in true]
    true_t = params_from_numpy(true)

    class JB:
        @staticmethod
        def batch(kb):
            pts, valid = j_sampling.training_points(kb, jf.n_batch,
                                                    jf.scene)
            return (pts, jf.velocity(true_j, pts, eps=jnp.float32(eps)),
                    valid.astype(jnp.float32))

        velocity = staticmethod(lambda p, x: jf.velocity(
            p, x, eps=jnp.float32(eps)))
        features = staticmethod(lambda p, x: j_features(p, jcfg, x))
        affine = staticmethod(lambda x: jf.velocity_affine(
            x, eps=jnp.float32(eps), t=1))

    class TB(_PhaseBatches):
        def batch(self, kb):
            pts, w = self.points(kb)
            return pts, self.velocity(true_t, pts), w

    key = jax.random.PRNGKey(7)
    out_j = j_ls_head(jf, [(jnp.asarray(a), jnp.asarray(c)) for a, c in bad],
                      key, JB)
    out_t = t_ls_head(tf, params_from_numpy(bad), JaxKey(key),
                      TB(tf, eps, 1))
    head_moved_j = not np.array_equal(np.asarray(out_j[-1][0]), bad[-1][0])
    head_moved_t = not np.array_equal(to_np(out_t[-1][0]), bad[-1][0])
    assert head_moved_j == head_moved_t
    for a, b in zip(params_np(out_t), params_np(out_j)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
