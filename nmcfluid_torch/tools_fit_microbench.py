"""A fresh-batch fit iteration taken apart on the card (port of
nmcfluid/tools_fit_microbench.py).

    python -m nmcfluid_torch.tools_fit_microbench [--scene smoke]
        [--iters 200] [--n_batch N] [--quick] [--device cuda|cpu]

At a scene's real shapes (its SIREN, sample_resolution^2 points), the
ingredients of the port's fresh-batch iteration (sim/fluid.py::
_adam_fit_single), each cumulative: the raw SIREN forward, the forward
with the scene's hard boundary conditions, the loss's value and gradient
by autograd, + the Adam update, + the sampling and the advection target
(three velocity evaluations of the previous field) as _AdvectBatches
builds it; then the loop itself (_adam_fit_single, ls_head off) on the
advection batches, and one iteration of the fit kernel
(csrc/fitkernel.cu, on a K = 8 pool of the same shapes) for comparison.
Each is timed twice, as tools_walk_roofline.Timer does: device ms an
iteration by CUDA events with the calls queued behind a sleep kernel, and
host ms an iteration with the card drained after each (beside them the
kernels' own time from a profiler window, not with --quick); the loop
and the kernel by one synchronized run of --iters iterations. Prints one JSON
line headed by the card's name and power limit. Without a card it
refuses; --device cpu rehearses it (host times only, the kernel's CPU
twin).
"""
import argparse
import json
import time

import torch

from .tools_walk_roofline import NOT_MEASURED, Timer, _sync, card_line


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nmcfluid_torch."
                                 "tools_fit_microbench")
    ap.add_argument("--scene", default="smoke")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--n_batch", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="20 iterations of the loop and the kernel, 3 "
                         "calls a measurement, no profiler window")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tools_fit_microbench: needs a CUDA device "
                         "(--device cpu rehearses it without times)")
    from .models.siren import apply_siren
    from .scenes import get_scene
    from .sim import fitkernel as fk
    from .sim import fluid as tf
    from .utils.keys import Key

    iters = 20 if args.quick else args.iters
    scene = get_scene(args.scene)
    n = args.n_batch or scene.sample_resolution ** 2
    fluid = tf.NeuralFluid(scene, device=dev, fit_mode="xla", ls_head=0,
                           max_n_iters=iters,
                           sample_resolution=int(round(n ** 0.5)))
    key = Key(0)
    params = fluid.init_state(key=key).params
    prev = fluid.init_state(key=key.fold_in(1)).params
    cfg, dim, eps = fluid.siren_cfg, scene.dim, scene.bdry_eps
    batches = tf._AdvectBatches(fluid, False, prev, prev, scene.dt, eps, 0)
    x0, target0, w0 = batches.batch(key.fold_in(2))
    leaves = [t for pair in params for t in pair]
    sizes = [t.numel() for t in leaves]
    flat0 = torch.cat([t.reshape(-1) for t in leaves])
    m0, v0 = torch.zeros_like(flat0), torch.zeros_like(flat0)

    def unflat(flat):
        parts = [p.view(t.shape) for p, t in zip(flat.split(sizes), leaves)]
        return list(zip(parts[0::2], parts[1::2]))

    def value_and_grad(x, target, w):
        with torch.enable_grad():
            p = flat0.detach().requires_grad_(True)
            loss = tf._batch_loss(batches, unflat(p), x, target, w, dim)
            g, = torch.autograd.grad(loss, p)
        return loss, g

    def adam(x, target, w):
        _, g = value_and_grad(x, target, w)
        return tf.adam_update(flat0, m0, v0, g, scene.lr, 0.1, 0.001)

    timer = Timer(dev, n=3 if args.quick else 8, profile=not args.quick)
    res = {"card": card_line() if dev.type == "cuda" else NOT_MEASURED,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu (a rehearsal: no device number)"),
           "torch": torch.__version__, "scene": args.scene, "n_batch": n,
           "layers": f"{cfg.num_hidden_layers}x{cfg.hidden_features}",
           "iters": iters}
    with torch.no_grad():
        steps = {
            "fwd_raw_net": lambda: apply_siren(params, cfg, x0),
            "fwd_with_bc": lambda: fluid.velocity(params, x0, eps=eps, t=0),
            "value_and_grad": lambda: value_and_grad(x0, target0, w0),
            "vg_plus_adam": lambda: adam(x0, target0, w0),
            "full_advect_iter": lambda: adam(*batches.batch(
                key.fold_in(3))),
        }
        res["ms_per_iter"] = {k: timer(fn) for k, fn in steps.items()}
        # the loop as a phase fit runs it, and the fit kernel
        tf._adam_fit_single(fluid, params, key, batches)      # warm
        _sync(dev)
        t0 = time.perf_counter()
        _, stats = tf._adam_fit_single(fluid, params, key, batches)
        _sync(dev)
        res["ms_per_iter"]["adam_fit_single"] = {
            "host_ms": (time.perf_counter() - t0) * 1e3 / iters,
            "executor": stats.executor, "fit_iters": stats.iters}
        K = 8
        pool = [[] for _ in range(5)]
        for i in range(K):
            x, target, w = batches.batch(key.fold_in(100 + i))
            A, c = batches.affine(x)
            for lst, a in zip(pool, (x, A, c, target, w)):
                lst.append(a)
        pool = tuple(torch.stack(lst) for lst in pool)

        def kernel():
            return fk.fused_adam_fit(params, cfg, pool, iters, scene.lr)
        kernel()                                               # warm
        _sync(dev)
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if dev.type == "cuda" else None)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        kernel()
        if ev:
            ev[1].record()
        _sync(dev)
        res["ms_per_iter"]["fit_kernel"] = {
            "host_ms": (time.perf_counter() - t0) * 1e3 / iters,
            "device_ms": (ev[0].elapsed_time(ev[1]) / iters if ev
                          else NOT_MEASURED),
            "executor": "fit kernel" if dev.type == "cuda" else "plain twin",
            "K": K}
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
