"""Split the Taylor-Green source fit of the two packages on the same draws.

    JAX_PLATFORMS=cpu python tests/source_split.py --seed S --out DIR \\
        [--iters N] [--small]

Runs `add_source(init_state(S))` of the shipped TG configuration in both
packages on the CPU, on the same random numbers (the port with the
JAX-replay key of tests/_torch_parity.py), both with the fused fit's
semantics: a pool of K minibatches cycled by Adam, then the closed-form
head solve (ls_head). The JAX package's fused fit runs its XLA mirror
`fitkernel.reference_adam_fit` (its Pallas kernel would run interpreted
on the CPU), the port's its plain twin. Prints one JSON line with, for
each package, the TG velocity error (raw 1000^2 grid) and the loss after
the Adam phase and after the head solve, and the largest parameter
difference between the packages; writes both states as
`DIR/{jax_fused,port_fused}/ckpt_step_t000.npz` for `python -m
nmcfluid_torch.sim.stageprobe --frames` to step. --iters sets the Adam
iterations (default the scene's 10,000).

The JAX package's CPU default (fit_mode "auto" = its fresh-batch loop,
a fresh minibatch every iteration) is what `port_stages.py
--source_seed` and docs/tg_jax_seed*/ ran; this script holds the fused
fit, the executor of the port and of the JAX package on its accelerator.
It imports both packages, like the parity tests beside it.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import JaxKey, params_np  # noqa: E402


def run(seed, out, small=False, iters=None):
    import nmcfluid.sim.fitkernel as jfk
    import nmcfluid.sim.fluid as jfluid
    import nmcfluid_torch.sim.fluid as tfluid
    from nmcfluid.scenes import get_scene as j_get_scene
    from nmcfluid.transport.density import raw_velocity_grid as j_raw
    from nmcfluid.utils.checkpoint import save_ckpt
    from nmcfluid_torch.scenes import get_scene as t_get_scene
    from nmcfluid_torch.transport.density import (raw_velocity_grid as t_raw,
                                                  tg_velocity_error)

    kw = {}
    res = 1000
    if small:
        kw = dict(max_n_iters=30, sample_resolution=8, fit_pool=4)
        res = 64
    if iters:
        kw["max_n_iters"] = iters
    stages = {"jax": {}, "port": {}}

    def j_err(p):
        return tg_velocity_error(torch.from_numpy(np.asarray(
            j_raw(jf, p, res)).copy()))

    def t_err(p):
        return tg_velocity_error(t_raw(tf, p, res))

    # the head solve's input is the Adam phase's output
    j_solve, t_solve = jfluid._ls_head_solve, tfluid._ls_head_solve
    adam_out = {}

    def j_wrapped(fluid, params, key, batch_fn):
        jax.debug.callback(lambda *leaves: adam_out.__setitem__(
            "jax", [np.asarray(a) for a in leaves]),
            *[a for pair in params for a in pair])
        return j_solve(fluid, params, key, batch_fn)

    def t_wrapped(fluid, params, key, batch_fn):
        adam_out["port"] = params_np(params)
        return t_solve(fluid, params, key, batch_fn)

    def as_pairs(leaves, like):
        return [tuple(leaves[2 * i:2 * i + 2]) for i in range(len(like))]

    mp_j = [(jfk, "fused_adam_fit", jfk.reference_adam_fit),
            (jfluid, "_ls_head_solve", j_wrapped),
            (tfluid, "_ls_head_solve", t_wrapped)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in mp_j]
    try:
        for m, n, v in mp_j:
            setattr(m, n, v)
        t0 = time.perf_counter()
        jf = jfluid.NeuralFluid(j_get_scene("taylorgreen"),
                                fit_mode="fused", **kw)
        js = jf.add_source(jf.init_state(seed))
        jax.effects_barrier()
        t_jax = time.perf_counter() - t0
        t0 = time.perf_counter()
        tf = tfluid.NeuralFluid(t_get_scene("taylorgreen"), device="cpu",
                                **kw)
        ts = tf.add_source(tf.init_state(key=JaxKey.from_seed(seed)))
        t_port = time.perf_counter() - t0
    finally:
        for m, n, v in saved:
            setattr(m, n, v)
    like = ts.params
    stages["jax"] = {
        "after_adam": j_err(as_pairs(adam_out["jax"], like)),
        "after_head": j_err(js.params),
        "loss": float(jf._last_stats.loss), "seconds": t_jax}
    stages["port"] = {
        "after_adam": t_err([tuple(torch.from_numpy(a) for a in pair)
                             for pair in as_pairs(adam_out["port"], like)]),
        "after_head": t_err(ts.params),
        "loss": float(tf._last_stats.loss), "seconds": t_port}
    diff = max(float(np.abs(a - b).max()) for a, b in zip(
        params_np(ts.params), params_np(js.params)))
    res_line = {"seed": seed, "tg_err": stages, "max_param_diff": diff,
                "device": "cpu"}
    if out:
        save_ckpt(os.path.join(out, "jax_fused"), js.params, 0)
        save_ckpt(os.path.join(out, "port_fused"),
                  [tuple(np.asarray(a) for a in pair)
                   for pair in as_pairs(params_np(ts.params), like)], 0)
    print(json.dumps(res_line), flush=True)
    return res_line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes, for a rehearsal")
    args = ap.parse_args(argv)
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    return run(args.seed, args.out, args.small, args.iters)


if __name__ == "__main__":
    main()
