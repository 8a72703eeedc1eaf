"""The comparison baselines (nmcfluid_torch/baselines) against the JAX
package's (nmcfluid/baselines), on the CPU at small sizes.

The port's key seam replays jax.random (JaxKey), so both packages draw the
same points. Held, each at the tolerance stated in its test:
- the samplers and the three inits bit for bit;
- the written-out derivative passes (apply_siren_tangents,
  apply_siren_second) against JAX's vmap of jacfwd and hessian, within
  1e-5 of the magnitude;
- each loss at iteration 0 against jax.value_and_grad of the JAX loss:
  the loss at rtol 1e-5, its gradient at rtol 1e-4 with an atol of 1e-6 of
  the largest gradient entry;
- SegmentedAdam over 20 iterations (the count equal, the weights at
  tests/test_fitkernel.py's rtol 2e-4 / atol 2e-6), the plateau schedule
  to its stop and the exponential decay's lr (equal);
- both runners on each method (error files at rtol 1e-4), INSR's cut and
  resumed run against its uncut run (bit for bit), INSR checkpoints
  loading across the packages, and the runner refusing to start without
  a card unless given --device cpu.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, to_np

import nmcfluid.baselines as jb
import nmcfluid.baselines.common as jcommon
import nmcfluid.baselines.pideep_probe as jprobe
import nmcfluid.baselines.pideeponet as jpd
import nmcfluid.baselines.pinn as jpinn
import nmcfluid.baselines.run as jrun
import nmcfluid_torch.baselines as tb
import nmcfluid_torch.baselines.common as tcommon
import nmcfluid_torch.baselines.pideep_probe as tprobe
import nmcfluid_torch.baselines.run as trun
from nmcfluid.models import siren as jsiren
from nmcfluid.utils.checkpoint import load_ckpt as j_load_ckpt
from nmcfluid.utils.checkpoint import save_ckpt as j_save_ckpt
from nmcfluid_torch.models import siren as tsiren
from nmcfluid_torch.utils.checkpoint import load_ckpt as t_load_ckpt
from nmcfluid_torch.utils.checkpoint import save_ckpt as t_save_ckpt
from nmcfluid_torch.utils.checkpoint import tree_leaves, tree_unflatten
from nmcfluid_torch.utils.keys import Key

NET = dict(num_hidden_layers=2, hidden_features=32)
TINY = dict(NET, sample_resolution=12)
CLASSES = {"insr": (jb.INSRFluid, tb.INSRFluid),
           "pinn": (jb.PINNFluid, tb.PINNFluid),
           "pideeponet": (jb.PIDeepONetFluid, tb.PIDeepONetFluid)}


def _leaves_np(tree):
    return [to_np(t) for t in tree_leaves(tree)]


def _assert_tree_equal(t_tree, j_tree):
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    t_leaves = _leaves_np(t_tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))


def _models(method, **kw):
    jcls, tcls = CLASSES[method]
    return jcls(**TINY, **kw), tcls(**TINY, device="cpu", **kw)


def test_samplers_bit_equal():
    k = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(
        to_np(tcommon.sample_interior(JaxKey(k), 300, "cpu")),
        np.asarray(jcommon.sample_interior(k, 300)))
    for a, b in zip(tcommon.sample_boundary(JaxKey(k), 64, "cpu"),
                    jcommon.sample_boundary(k, 64)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    xv, xh = tcommon.sample_boundary(Key(1), 64, "cpu")
    assert torch.all(xv[:, 0].abs() == 1.0) and torch.all(
        xh[:, 1].abs() == 1.0)


@pytest.mark.parametrize("method", sorted(CLASSES))
def test_init_bit_equal(method):
    jm, tm = _models(method)
    _assert_tree_equal(tm.init(key=JaxKey.from_seed(3)), jm.init(3))


@pytest.mark.parametrize("method", sorted(CLASSES))
def test_own_key_init_has_the_jax_init_distribution(method):
    """The initial weights the port draws with its own key
    (utils/keys.py) come from the JAX init's distribution: each leaf of
    seeds 0-8 pooled, at port_baselines.py's 3 x 64 nets, against the JAX
    package's init of the same seeds, by the two-sample Kolmogorov-Smirnov
    statistic under its critical value at level 1e-6, c n^-1/2 with
    c = sqrt(ln(2 / 1e-6) / 2) and n the two samples' harmonic size; a
    constant leaf equal. PI-DeepONet's own-key tail follows the initial
    weights (ROADMAP queue 3, item 19): this holds that their draw is
    JAX's, not the port's own."""
    from scipy import stats
    jcls, tcls = CLASSES[method]
    net = dict(num_hidden_layers=3, hidden_features=64)
    jm, tm = jcls(**net), tcls(**net, device="cpu")
    seeds = range(9)
    j_leaves = [np.concatenate([np.asarray(a).ravel() for a in leaves])
                for leaves in zip(*[jax.tree_util.tree_leaves(jm.init(s))
                                    for s in seeds])]
    t_leaves = [np.concatenate([a.ravel() for a in leaves])
                for leaves in zip(*[_leaves_np(tm.init(key=Key(s)))
                                    for s in seeds])]
    assert len(j_leaves) == len(t_leaves)
    c = np.sqrt(np.log(2 / 1e-6) / 2)
    for i, (a, b) in enumerate(zip(t_leaves, j_leaves)):
        assert a.shape == b.shape, i
        if np.all(b == b[0]):
            np.testing.assert_array_equal(a, b)
            continue
        d = stats.ks_2samp(a, b).statistic
        assert d < c * np.sqrt(2 / a.size), (i, a.size, d)


def test_tg_velocity_matches_jax():
    """The analytic field on random points, to f32 rounding of sin/cos."""
    x = np.random.default_rng(0).uniform(-1, 1, (500, 2)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tcommon.tg_velocity(torch.from_numpy(x))),
        np.asarray(jcommon.tg_velocity(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("nonlinearity", ["sine", "relu", "elu", "tanh"])
def test_second_order_pass_matches_jax_hessian(nonlinearity):
    """apply_siren_second's u, du and the Laplacian sum_i d2u[i] against
    JAX's network, vmap(jacfwd) and the trace of vmap(hessian), per
    output, within 1e-5 of the largest magnitude of each."""
    cfg = dict(in_features=3, out_features=2, num_hidden_layers=2,
               hidden_features=32, nonlinearity=nonlinearity,
               normal_init_std=0.5)
    jcfg = jsiren.SirenConfig(**cfg)
    jp = jsiren.init_siren(jax.random.PRNGKey(2), jcfg)
    x = np.random.default_rng(1).uniform(-1, 1, (64, 3)).astype(np.float32)
    u, du, d2u = tsiren.apply_siren_second(
        tsiren.params_from_numpy(jp), tsiren.SirenConfig(**cfg),
        torch.from_numpy(x))

    def f(p):
        return jsiren.apply_siren(jp, jcfg, p)
    xj = jnp.asarray(x)
    ju = f(xj)
    jjac = jax.jit(jax.vmap(jax.jacfwd(f)))(xj)         # (N, out, in)
    jhess = jax.jit(jax.vmap(jax.hessian(f)))(xj)       # (N, out, in, in)
    jlap = jnp.trace(jhess, axis1=-2, axis2=-1)         # (N, out)
    for got, want in ((u, ju), (du.permute(1, 2, 0), jjac),
                      (d2u.sum(0), jlap)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_diff_ops_laplacian_matches_jax():
    """ops/diff_ops.laplacian (nested jvps) of a scalar SIREN against the
    JAX package's (trace of vmap(hessian)) and against apply_siren_second,
    within 1e-5 of the largest magnitude."""
    from nmcfluid.ops.diff_ops import laplacian as j_laplacian
    from nmcfluid_torch.ops.diff_ops import laplacian as t_laplacian
    jcfg = jsiren.SirenConfig(2, 1, 2, 32)
    jp = jsiren.init_siren(jax.random.PRNGKey(4), jcfg)
    tp, tcfg = tsiren.params_from_numpy(jp), tsiren.SirenConfig(2, 1, 2, 32)
    x = np.random.default_rng(2).uniform(-1, 1, (5, 7, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda y: j_laplacian(
        lambda p: jsiren.apply_siren(jp, jcfg, p), y))(jnp.asarray(x)))
    got = t_laplacian(lambda p: tsiren.apply_siren(tp, tcfg, p),
                      torch.from_numpy(x))
    assert got.shape == want.shape == (5, 7)
    atol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=atol)
    d2u = tsiren.apply_siren_second(tp, tcfg, torch.from_numpy(x).reshape(
        -1, 2))[2]
    np.testing.assert_allclose(to_np(d2u.sum(0)).reshape(5, 7), want, rtol=0,
                               atol=atol)


def test_second_order_pass_refuses_unknown_nonlinearity():
    cfg = tsiren.SirenConfig(2, 1, 1, 8)
    p = tsiren.init_siren(Key(0), cfg)
    with pytest.raises(NotImplementedError, match="'swish'"):
        tsiren.apply_siren_second(
            p, tsiren.SirenConfig(2, 1, 1, 8, nonlinearity="swish"),
            torch.zeros(4, 2))


def _captured_loss(module, m, st):
    """The loss closure the JAX trainer hands to adam_fit."""
    got = {}

    def fake(state, key, loss_fn, *a, **kw):
        got["loss"] = loss_fn
        return state, 0, 0.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "adam_fit", fake)
        m.train(st, jax.random.PRNGKey(0))
    return got["loss"]


def _loss_pair(case):
    """(JAX loss, JAX params, JAX ctx, port loss, port params, port ctx)
    of one loss, from the same weights."""
    method = "insr" if case.startswith("insr") else case
    jm, tm = _models(method)
    js, ts = jm.init(0), tm.init(key=JaxKey.from_seed(0))
    js1, ts1 = jm.init(1), tm.init(key=JaxKey.from_seed(1))
    if case == "insr_source":
        return (jm._source_loss, js["vel"], (), tm._source_loss, ts["vel"],
                ())
    if case == "insr_advect":
        return (jm._advect_loss, js["vel"], (js1["vel"],), tm._advect_loss,
                ts["vel"], (ts1["vel"],))
    if case == "insr_pressure":
        return (jm._pressure_loss, js["p"], (js1["vel"],),
                tm._pressure_loss, ts["p"], (ts1["vel"],))
    if case == "insr_project":
        return (jm._project_loss, js["vel"], (js1["vel"], js1["p"]),
                tm._project_loss, ts["vel"], (ts1["vel"], ts1["p"]))
    module = jpinn if case == "pinn" else jpd
    return _captured_loss(module, jm, js), js, (), tm.loss, ts, ()


@pytest.mark.parametrize("case", ["insr_source", "insr_advect",
                                  "insr_pressure", "insr_project", "pinn",
                                  "pideeponet"])
def test_loss_and_gradient_match_jax(case):
    """Iteration 0's loss and its gradient by the weights against
    jax.value_and_grad of the JAX loss, on the same weights and key: the
    loss at rtol 1e-5, each gradient entry at rtol 1e-4 with an atol of
    1e-6 of the largest gradient entry."""
    jloss, jp, jctx, tloss, tp, tctx = _loss_pair(case)
    k = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp, k, *jctx)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tp)]
    lt = tloss(tree_unflatten(tp, leaves), JaxKey(k), *tctx)
    # the pressure loss reads derivatives only: p's last bias gets none
    gt = torch.autograd.grad(lt, leaves, allow_unused=True,
                             materialize_grads=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gj = [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)]
    mag = max(np.abs(g).max() for g in gj)
    assert mag > 0 and len(gt) == len(gj)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(to_np(a), b, rtol=1e-4, atol=1e-6 * mag)


def test_segmented_adam_matches_jax():
    """INSR's source fit over 20 iterations: the count equal, the weights
    at rtol 2e-4 / atol 2e-6 (tests/test_fitkernel.py's), the loss at
    rtol 1e-4."""
    jm, tm = _models("insr", max_n_iters=20)
    jv, ji, jl = jm.fit_source(jm.init(0)["vel"], jax.random.PRNGKey(4))
    tv, ti, tl = tm.fit_source(tm.init(key=JaxKey.from_seed(0))["vel"],
                               JaxKey.from_seed(4))
    assert ti == int(ji) == 20
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for a, b in zip(_leaves_np(tv), jax.tree_util.tree_leaves(jv)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-6)


def _stalling_loss(backend):
    """1 + mean(w^2) with w ~ 1e-3: Adam's steps of lr improve it by far
    less than the plateau's relative 1e-4, so it stalls from iteration 1."""
    def loss(p, key):
        return 1.0 + backend.mean(p[0] ** 2)
    return loss


def test_plateau_schedule_stops_with_jax():
    """A stalling loss drives INSR's plateau schedule through its four
    drops (1e-4 -> ~1e-8) to the lr stop: the lr after the fit's end at
    each cut (just before and after each drop) and the stop iteration
    equal JAX's exactly; the weights (near 0, where Adam's steps follow
    the rounding of tiny gradients) at rtol 2e-4 / atol 2e-6."""
    w = np.full((4,), 1e-3, np.float32)
    jfit = jcommon.SegmentedAdam(_stalling_loss(jnp), 1e-4, plateau=True)
    tfit = tcommon.SegmentedAdam(_stalling_loss(torch), 1e-4, plateau=True)
    opt = jfit.opt.init([jnp.asarray(w)])
    carry = (jnp.int32(0), [jnp.asarray(w)], opt, jnp.float32(jnp.inf),
             jnp.float32(1e-4), jnp.float32(jnp.inf), jnp.int32(0))
    cuts = [502, 503, 1004, 2006, 2008, 2400]
    for hi in cuts:
        i, params, opt, loss, lr, best, stall = jfit._segment(
            carry[1], carry[2], jax.random.PRNGKey(0), carry[0],
            jnp.int32(hi), *carry[3:], ())
        carry = (i, params, opt, loss, lr, best, stall)
        # the port restarts from scratch for each cut
        p, ti, tl = tfit.fit([torch.from_numpy(w)], Key(0), hi)
        assert ti == int(i), (hi, ti, int(i))
        assert np.float32(tfit.lr) == np.asarray(lr), (hi, tfit.lr, lr)
        np.testing.assert_allclose(to_np(p[0]), np.asarray(params[0]),
                                   rtol=2e-4, atol=2e-6)
    assert int(carry[0]) == 2005 < cuts[-1]     # stopped by the lr floor
    assert float(carry[4]) <= 1.1e-8


def test_exp_gamma_lr_matches_jax_product():
    """The exponential schedule's lr after N steps equals JAX's, and the
    f32 product lr0 * gamma * ... * gamma, bit for bit."""
    w = np.full((3,), 0.5, np.float32)
    gamma = 0.95 ** 1e-4
    tfit = tcommon.SegmentedAdam(lambda p, k: torch.sum(p[0] ** 2), 1e-4,
                                 exp_gamma=gamma)
    jfit = jcommon.SegmentedAdam(lambda p, k: jnp.sum(p[0] ** 2), 1e-4,
                                 exp_gamma=gamma)
    n = 300
    tfit.fit([torch.from_numpy(w)], Key(0), n)
    *_, lr, _, _ = jfit._segment(
        [jnp.asarray(w)], jfit.opt.init([jnp.asarray(w)]),
        jax.random.PRNGKey(0), jnp.int32(0), jnp.int32(n),
        jnp.float32(jnp.inf), jnp.float32(1e-4), jnp.float32(jnp.inf),
        jnp.int32(0), ())
    want = np.float32(1e-4)
    for _ in range(n):
        want = want * np.float32(gamma)
    assert np.float32(tfit.lr) == np.asarray(lr) == want


@pytest.fixture
def small_runners(monkeypatch):
    """Both runners at 2 x 32 (the shipped nets are 3 x 256), the port's
    key seam replaying jax.random."""
    for module in (jrun, trun):
        for name in ("INSRFluid", "PINNFluid", "PIDeepONetFluid"):
            monkeypatch.setattr(module, name, functools.partial(
                getattr(module, name), **NET))
    monkeypatch.setattr(trun, "Key", JaxKey)


RUN = ["--max_n_iters", "25", "--sample_resolution", "10", "--grid", "12"]


@pytest.mark.parametrize("method", sorted(CLASSES))
def test_runner_matches_jax(method, small_runners, tmp_path):
    """Both runners, the same flags: the error files at rtol 1e-4."""
    frames = ["--frames", "2"]
    jrun.main([method, "--out", str(tmp_path / "jax")] + frames + RUN)
    trun.main([method, "--out", str(tmp_path / "torch"), "--device", "cpu"]
              + frames + RUN)
    for f in (f"error_{method}.txt", f"error_{method}_refpipe.txt"):
        got = np.loadtxt(tmp_path / "torch" / f)
        want = np.loadtxt(tmp_path / "jax" / f)
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_insr_runner_resume_matches_uncut(tmp_path):
    """A cut-and-resumed INSR run reproduces the uncut curve exactly (the
    per-frame key is key.fold_in(f + 1); the state round-trips via npz):
    the counterpart of tests/test_baselines.py's."""
    tiny = ["--max_n_iters", "30", "--sample_resolution", "10",
            "--grid", "12", "--device", "cpu"]
    a, b = str(tmp_path / "uncut"), str(tmp_path / "cut")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trun, "INSRFluid", functools.partial(trun.INSRFluid,
                                                        **NET))
        trun.main(["insr", "--frames", "3", "--out", a] + tiny)
        trun.main(["insr", "--frames", "2", "--out", b] + tiny)
        trun.main(["insr", "--frames", "3", "--out", b, "--resume"] + tiny)
    for f in ("error_insr.txt", "error_insr_refpipe.txt"):
        ea, eb = np.loadtxt(f"{a}/{f}"), np.loadtxt(f"{b}/{f}")
        assert ea.shape == (3,)
        np.testing.assert_array_equal(ea, eb)


def test_insr_checkpoint_cross_loads(tmp_path):
    """An INSR state saved by either package loads in the other, leaf for
    leaf, in JAX's leaf order: p's leaves before vel's."""
    jm, tm = _models("insr")
    js, ts = jm.init(0), tm.init(key=Key(9))
    j_save_ckpt(str(tmp_path / "j"), js, 1)
    got, t = t_load_ckpt(str(tmp_path / "j"), ts, 1)
    assert t == 1 and list(got) == ["vel", "p"]
    _assert_tree_equal(got, js)
    t_save_ckpt(str(tmp_path / "t"), ts, 2)
    got, t = j_load_ckpt(str(tmp_path / "t"), js, 2)
    assert t == 2
    for key in ("vel", "p"):
        for a, b in zip(jax.tree_util.tree_leaves(got[key]),
                        _leaves_np(ts[key])):
            np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(tmp_path / "t" / "ckpt_step_t002.npz") as z:
        np.testing.assert_array_equal(z["leaf_0"], to_np(ts["p"][0][0]))


def test_main_without_card_raises_before_writing(tmp_path):
    """No --device: the card, and a RuntimeError here before any file."""
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["pinn", "--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprobe.main(["supervised", "--out", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("probe", ["supervised", "coef"])
def test_pideep_probe_matches_jax(probe, tmp_path):
    """Both probes at 2 x 32, 20 basis functions a field, the same flags:
    the curves at rtol 1e-4."""
    args = [probe, "--n_out", "60", "--max_n_iters", "15",
            "--sample_resolution", "10", "--frames", "2", "--grid", "12"]
    with pytest.MonkeyPatch.context() as mp:
        for module in (jprobe, tprobe):
            mp.setattr(module, "PIDeepONetFluid", functools.partial(
                module.PIDeepONetFluid, **NET))
        mp.setattr(tprobe, "Key", JaxKey)
        jprobe.main(args + ["--out", str(tmp_path / "jax")])
        tprobe.main(args + ["--out", str(tmp_path / "torch"), "--device",
                            "cpu"])
    for f in (f"probe_pideep_{probe}_n60.txt",
              f"probe_pideep_{probe}_n60_refpipe.txt"):
        np.testing.assert_allclose(np.loadtxt(tmp_path / "torch" / f),
                                   np.loadtxt(tmp_path / "jax" / f),
                                   rtol=1e-4)
