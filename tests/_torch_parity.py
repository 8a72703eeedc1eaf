"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

`JaxKey` is the second implementation of the port's key seam
(nmcfluid_torch/utils/keys.py): it holds a `jax.random` key and replays
every split, fold_in and draw through jax.random, handing the numbers to
the port as torch tensors. With it the port walks the same random numbers
as the JAX package, so whole steps can be held against each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmcfluid_torch.ops.fastrand import seed_from_words

# one intra-op thread: the suite runs several xdist workers side by side
torch.set_num_threads(1)


class JaxKey:
    """Key object replaying jax.random (see the module docstring)."""

    def __init__(self, key):
        self.key = key

    @classmethod
    def from_seed(cls, seed):
        return cls(jax.random.PRNGKey(seed))

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def uniform(self, shape, device, minval=0.0, maxval=1.0):
        u = jax.random.uniform(self.key, tuple(shape), jnp.float32,
                               minval, maxval)
        return torch.from_numpy(np.asarray(u).copy()).to(device)

    def randint(self, shape, lo, hi, device):
        r = jax.random.randint(self.key, tuple(shape), lo, hi)
        return torch.from_numpy(np.asarray(r).astype(np.int64)).to(device)

    def stream_seed(self):
        w0, w1 = (int(v) for v in np.asarray(
            jax.random.key_data(self.key)).astype(np.uint32))
        return seed_from_words(w0, w1)


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def params_np(params):
    """A parameter list of either package as a flat list of numpy arrays."""
    return [to_np(a) for pair in params for a in pair]


def _record(monkeypatch, module, log, jax_side):
    """Log each phase fit's output params, its ls_head branch (True when
    the solved head replaced the Adam endpoint) and each phase's initial
    weights (`_phase_init`); on the JAX side also each pressure chunk's
    inputs and outputs."""
    fits = {name: getattr(module, name)
            for name in ("_fit_source", "_fit_advect", "_fit_project")}
    for name, fn in fits.items():
        def wrapped(*a, _fn=fn, _name=name, **kw):
            params, stats = _fn(*a, **kw)
            log["fits"].append((_name, params_np(params)))
            return params, stats
        monkeypatch.setattr(module, name, wrapped)
    solve = module._ls_head_solve

    def ls_wrapped(fluid, params, key, batch_fn):
        out = solve(fluid, params, key, batch_fn)
        if jax_side:
            moved = jnp.any(out[-1][0] != params[-1][0])
            jax.debug.callback(lambda m: log["branch"].append(bool(m)),
                               moved)
        else:
            log["branch"].append(out[-1][0] is not params[-1][0])
        return out
    monkeypatch.setattr(module, "_ls_head_solve", ls_wrapped)
    init = module.NeuralFluid._phase_init

    def init_wrapped(self, state, key):
        out = init(self, state, key)
        log["init"].append(params_np(out))
        return out
    monkeypatch.setattr(module.NeuralFluid, "_phase_init", init_wrapped)
    if jax_side:
        solve_p = module._pressure_solve

        def p_wrapped(fluid, wsc, source_args, key):
            out = solve_p(fluid, wsc, source_args, key)
            log["pressure"].append((np.asarray(source_args[0]), key,
                                    [np.asarray(a) for a in out]))
            return out
        monkeypatch.setattr(module, "_pressure_solve", p_wrapped)


def chained_runs(scene, sizes, halve_eps=False):
    """add_source + step of `scene` in both packages from seed 0, the port
    with the JAX-replay key and the JAX package with its fused fit (the
    Pallas kernel in interpret mode); `halve_eps` halves the ramp width
    between the two, as the JAX CLI does for the karman family
    (nmcfluid/run.py:498-500). Returns (jax fluid, jax state, port fluid,
    port state, logs) with the logs of `_record`."""
    import nmcfluid.sim.fluid as jfluid
    import nmcfluid_torch.sim.fluid as tfluid
    from nmcfluid.scenes import get_scene as j_get_scene
    from nmcfluid_torch.scenes import get_scene as t_get_scene

    mp = pytest.MonkeyPatch()
    logs = {"jax": {"fits": [], "branch": [], "init": [], "pressure": []},
            "torch": {"fits": [], "branch": [], "init": []}}
    try:
        _record(mp, jfluid, logs["jax"], True)
        _record(mp, tfluid, logs["torch"], False)
        jf = jfluid.NeuralFluid(j_get_scene(scene), fit_mode="fused",
                                **sizes)
        js = jf.add_source(jf.init_state(0))
        if halve_eps:
            js = js._replace(eps=js.eps / 2)
        js = jf.step(js)
        jax.effects_barrier()
        tf = tfluid.NeuralFluid(t_get_scene(scene), device="cpu", **sizes)
        ts = tf.add_source(tf.init_state(key=JaxKey.from_seed(0)))
        if halve_eps:
            ts = ts._replace(eps=ts.eps / 2)
        ts = tf.step(ts)
    finally:
        mp.undo()
    return jf, js, tf, ts, logs
