"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

`JaxKey` is the second implementation of the port's key seam
(nmcfluid_torch/utils/keys.py): it holds a `jax.random` key and replays
every split, fold_in and draw through jax.random, handing the numbers to
the port as torch tensors. With it the port walks the same random numbers
as the JAX package, so whole steps can be held against each other.
"""
import json
import os

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

    def normal(self, shape, device):
        z = jax.random.normal(self.key, tuple(shape), jnp.float32)
        return torch.from_numpy(np.asarray(z).copy()).to(device)

    def randint(self, shape, lo, hi, device):
        r = jax.random.randint(self.key, tuple(shape), lo, hi)
        return torch.from_numpy(np.asarray(r).astype(np.int64)).to(device)

    def categorical(self, logits, shape):
        idx = jax.random.categorical(
            self.key, jnp.asarray(logits.detach().cpu().numpy()),
            shape=tuple(shape))
        return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(
            logits.device)

    def stream_seed(self):
        w0, w1 = (int(v) for v in np.asarray(
            jax.random.key_data(self.key)).astype(np.uint32))
        return seed_from_words(w0, w1)


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------- Monte Carlo checks drawn with the own key

# A list while port_key_audit.py reads the checks over many keys: each
# check below then records (what, the share of its tolerance the reading
# takes) instead of raising. None in a test run.
AUDIT = None


def mc_close(actual, desired, atol, what):
    """np.testing.assert_allclose(actual, desired, rtol=0, atol=atol) of
    a Monte Carlo estimate; the share is max |actual - desired| / atol."""
    a = np.asarray(to_np(actual), np.float64)
    d = np.asarray(to_np(desired), np.float64)
    if AUDIT is not None:
        AUDIT.append((what, float(np.max(np.abs(a - d))) / atol))
        return
    np.testing.assert_allclose(a, d, rtol=0, atol=atol, err_msg=what)


def mc_below(value, bound, what):
    """value < bound for a reading drawn by a walk (bound may be one
    too); the share is value / bound."""
    value, bound = float(value), float(bound)
    if AUDIT is not None:
        AUDIT.append((what, value / bound))
        return
    assert value < bound, (what, value, bound)


def mc_band(ratio, lo, hi, what):
    """lo <= ratio <= hi around 1; the share is the ratio's distance from
    1 over the distance of the band's edge on its side."""
    ratio = float(ratio)
    if AUDIT is not None:
        AUDIT.append((what, (ratio - 1.0) / (hi - 1.0) if ratio >= 1.0
                      else (1.0 - ratio) / (1.0 - lo)))
        return
    assert lo <= ratio <= hi, (what, ratio, lo, hi)


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


def walk_close(got, want, spread, rtol, atol, share=0.9):
    """At least `share` of the points at (rtol, atol); the others within
    four times the walk's own spread (the RMS difference of two keys'
    estimates over sqrt 2, per component). A walker on a wall decides
    whether the wall's own end vertices are silhouettes by the sign of
    d1 d2, which is a rounding error there; XLA contracts some products
    into FMAs and the port does not, so a position that differs in its
    last ulp can set another star radius and send that walk elsewhere.
    On the soup a few walks a point take another path in either package;
    the analytic boundaries have no such test, and tests/test_torch_walk.py
    holds their walks at the gen tolerance everywhere. Closed loops on a
    soup (custom scenes) meet the same test at their vertices."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    close = np.abs(got - want) <= atol + rtol * np.abs(want)
    close = close.reshape(close.shape[0], -1).all(-1)
    assert close.mean() >= share, close.mean()
    far = np.abs(got - want).reshape(close.shape[0], -1)[~close]
    assert np.all(far <= 4.0 * spread), (far.max(), spread)


def spread(a, b):
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.sqrt(np.mean(d ** 2)) / np.sqrt(2.0))


# ------------------------------------------------- the command-line tests

# tiny sizes of the CLI tests (tests/test_torch_run*.py), both CLIs on the
# fresh-batch fit
CLI_TINY = ["--n_timesteps", "1", "--max_n_iters", "20",
            "--sample_resolution", "8", "--wost_resolution", "16",
            "--div_resolution", "16", "--n_walks", "48",
            "--vis_resolution", "16", "--vel_vis_resolution", "8",
            "--density_resolution", "16", "--fit_mode", "xla"]


def capture_frames(mp, vis, frames):
    """Record every scalar frame a package's vis module draws, by file
    name, and still draw it."""
    draw = vis.draw_scalar_field2d

    def wrapped(arr, path, *a, **kw):
        frames[os.path.basename(path)] = np.asarray(arr)
        return draw(arr, path, *a, **kw)
    mp.setattr(vis, "draw_scalar_field2d", wrapped)


def replay_key_seam(mp):
    """The port's CLI keys (run.Key, replay.Key) replay jax.random."""
    import nmcfluid_torch.replay as treplay
    import nmcfluid_torch.run as trun
    mp.setattr(trun, "Key", JaxKey)
    mp.setattr(treplay, "Key", JaxKey)


def cli_pair(root, scene, extra):
    """Both CLIs on CLI_TINY + extra, the JAX one into root/jax and the
    port's (--device cpu, the key seam replaying jax.random) into
    root/torch. Returns (JAX experiment dir, port experiment dir,
    {"jax": frames, "torch": frames}) with the scalar frames each drew."""
    import nmcfluid.run as jrun
    import nmcfluid.utils.vis as jvis
    import nmcfluid_torch.run as trun
    import nmcfluid_torch.utils.vis as tvis
    frames = {"jax": {}, "torch": {}}
    with pytest.MonkeyPatch.context() as mp:
        capture_frames(mp, jvis, frames["jax"])
        capture_frames(mp, tvis, frames["torch"])
        replay_key_seam(mp)
        args = [scene] + CLI_TINY + extra
        jrun.main(args + ["--out", str(root / "jax")])
        trun.main(args + ["--out", str(root / "torch"), "--device", "cpu"])
    return root / "jax" / scene, root / "torch" / scene, frames


def ckpt_leaves(path):
    """(leaves, timestep) of a checkpoint file of either package."""
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        return [z[f"leaf_{i}"] for i in range(n)], int(z["timestep"])


def tree_files(root):
    """Every file under root, relative, sorted."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_ckpts_match(jdir, tdir, atols):
    """The checkpoints after add_source and after the step, leaf by leaf
    at rtol 2e-4 and atols[i] (the last atol for the leaves past the
    list)."""
    for t in (0, 1):
        name = f"model/ckpt_step_t{t:03d}.npz"
        (lj, tj), (lt, tt) = ckpt_leaves(jdir / name), ckpt_leaves(
            tdir / name)
        assert tj == tt == t and len(lj) == len(lt)
        for i, (a, b) in enumerate(zip(lt, lj)):
            np.testing.assert_allclose(a, b, rtol=2e-4,
                                       atol=atols[min(i, len(atols) - 1)])


def assert_same_files(jdir, tdir):
    """The same files, and the same numbers in the text outputs: loss
    traces, energy.txt and error_ours.txt at rtol 1e-2. The projection
    fits' targets carry grad p at the walk's rtol 2e-3 (tests/
    test_gen.py), and a loss is a square of such residuals. energy.txt
    adds the mean pressure P, a mean of p, at p's atol 2e-5 there."""
    assert tree_files(tdir) == tree_files(jdir)
    n_text = 0
    for rel in tree_files(jdir):
        if rel.startswith("txt/loss_") or rel in ("energy.txt",
                                                  "error_ours.txt"):
            np.testing.assert_allclose(
                np.loadtxt(tdir / rel), np.loadtxt(jdir / rel), rtol=1e-2,
                atol=2e-5 if rel == "energy.txt" else 0)
            n_text += 1
    assert n_text >= 3
    cfg_t = json.loads((tdir / "config.json").read_text())
    cfg_j = json.loads((jdir / "config.json").read_text())
    assert set(cfg_t) - set(cfg_j) == {"device"}
