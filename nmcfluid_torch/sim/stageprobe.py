"""Split one Taylor-Green step by stage, from a checkpoint.

    python -m nmcfluid_torch.sim.stageprobe --ckpt DIR --step K \\
        [--keys 0 1] [--out FILE.npz]
    python -m nmcfluid_torch.sim.stageprobe --curve error_ours.txt

Loads `DIR/ckpt_step_tKKK.npz` (either package's checkpoint), runs step
K + 1 of the shipped TG configuration stage by stage for each step key
(`Key(k)` for k in --keys), and prints one JSON line a key with:

- `tg_err`: the TG velocity error (raw 1000^2 grid,
  transport/density.py::tg_velocity_error) before the step, after the
  advection fit and after the projection fit;
- `loss`: each fit's final minibatch loss;
- `div_rms`: the RMS of the divergence grid of the advected field (what
  the projection must remove) and of the projected one (what it leaves);
- `walk`: the gen walk on the first 1,024 points of the step's pressure
  cloud, with the advected field's divergence grid: against an estimate
  of 16,000 walks (the points repeated 16,000 / n_walks times in one
  call, each copy on its own lanes, averaged), the
  mean difference of grad p (`bias`, per component), its RMS (`rms`) and
  the RMS difference of two n_walks estimates of independent keys over
  sqrt(2) (`noise`);
- `project_one_chunk`: the TG error and loss after a projection fit on
  the first 65,536-point chunk of the cloud alone (the size the JAX
  package's CPU counterpart, port_stages.py, fits on).

--out saves the first key's walk inputs and estimates (points, divergence
grid, the three estimates) for port_stages.py to hold the JAX package's
walk on the same points and grid. --curve prints the growth per frame
(least squares over rows --first.., 0-based, default 1) and the mean of
those rows of an error_ours.txt (one row a frame, row 0 after
add_source).

    python -m nmcfluid_torch.sim.stageprobe --ckpt DIR --step K \\
        --frames N [--seed S] [--projection P] [--curve_out FILE]

instead runs N whole steps from the checkpoint with the stepper on the
key tree of Key(S), as `python -m nmcfluid_torch.run taylorgreen --seed
S` runs them after add_source, and prints the TG error a frame (row 0
the checkpoint's), its growth and mean (curve_stats), and writes the
rows to --curve_out: the curve of the port's step from any starting
state, such as the JAX package's own add_source, under the projection
--projection (wost, spectral, bem or bvc; default wost).

Runs on the card unless given --device cpu (then with --small, a reduced
size for a rehearsal).
"""
import argparse
import json
import math
import time

import numpy as np
import torch

from ..scenes import get_scene
from ..transport.density import raw_velocity_grid, tg_velocity_error
from ..utils.checkpoint import load_ckpt
from ..utils.keys import Key
from ..wost.gen import estimate_solution_and_gradient_gen
from . import fluid as tfluid


def curve_stats(rows, first=1):
    """Growth per frame (the least-squares slope over rows first..) and
    the mean of rows first.. of an error curve."""
    y = np.asarray(rows, np.float64)[first:]
    x = np.arange(first, first + y.size, dtype=np.float64)
    slope = float(np.polyfit(x, y, 1)[0])
    return {"growth": slope, "mean": float(y.mean()), "rows": int(y.size)}


def walk_stats(g_a, g_b, g_ref):
    """Bias (mean difference per component), RMS difference against the
    reference, and the noise of one estimate (RMS of two independent
    estimates' difference over sqrt 2)."""
    d = g_a - g_ref
    return {"bias": d.mean(0).tolist(),
            "rms": float(d.pow(2).sum(-1).mean().sqrt()),
            "noise": float((g_a - g_b).pow(2).sum(-1).mean().sqrt()
                           / math.sqrt(2.0)),
            "ref_rms": float(g_ref.pow(2).sum(-1).mean().sqrt())}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def walk_estimates(fluid, pts, div_grid, key, n_walks, ref_walks):
    """Two n_walks estimates of grad p at pts (keys key.fold_in(1) and
    key.fold_in(2)) and one of ref_walks walks (key.fold_in(3); the
    points repeated, each copy on its own lanes, averaged)."""
    ws = fluid.walk_settings

    def est(p, k):
        return estimate_solution_and_gradient_gen(
            fluid._wost_scene, ws, p, k, n_walks=n_walks,
            source_args=(div_grid,))[1]
    g_a = est(pts, key.fold_in(1))
    g_b = est(pts, key.fold_in(2))
    reps = max(1, ref_walks // n_walks)
    g_ref = est(pts.repeat(reps, 1), key.fold_in(3))
    g_ref = g_ref.reshape(reps, pts.shape[0], -1).mean(0)
    return g_a, g_b, g_ref


def probe_step(fluid, params, step, key, walk_points=1024, ref_walks=16000,
               light=False):
    """The readings of one step from `params` at timestep `step` (see the
    module docstring); returns (readings, walk arrays). `light` reads
    only what port_stages.py reads for the JAX package too: the
    advection fit, its divergence grid, one chunk's walk and the
    projection fit on it (no walk arrays)."""
    dev = fluid.device
    scene = fluid.scene
    eps, t = float(scene.bdry_eps), step + 1
    times = {}

    def err(p):
        return tg_velocity_error(raw_velocity_grid(fluid, p, 1000))

    def rms(g):
        return float(g.double().pow(2).mean().sqrt())

    def timed(name, fn, *a):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*a)
        _sync(dev)
        times[name] = time.perf_counter() - t0
        return out

    out = {"tg_err": {"before": err(params)}, "loss": {}, "div_rms": {}}
    # the stepper's key tree (NeuralFluid.step, adv_ref off)
    _, k1, k2, k3, k4 = key.split(5)
    state = tfluid.SimState(params=params, P=torch.zeros((), device=dev),
                            eps=eps, timestep=t, key=key)
    p1, st_a = timed("advect_fit", tfluid._fit_advect, fluid, False,
                     fluid._phase_init(state, k1), params, params,
                     scene.dt, k2, eps, t)
    out["tg_err"]["after_advect"] = err(p1)
    out["loss"]["advect"] = float(st_a.loss)
    div = timed("div_grid", tfluid._divergence_grid, fluid, p1, eps, t)
    out["div_rms"]["before_project"] = rms(div)
    n_chunks = 1 if light else fluid.n_pressure // fluid.wost_chunk
    chunks = [timed(f"wost_chunk{c}", tfluid._pressure_solve, fluid,
                    (div,), k3.fold_in(c)) for c in range(n_chunks)]
    pts, valid, p, grad_p = (torch.cat(xs) for xs in zip(*chunks))
    if not light:
        p2, st_p = timed("project_fit", tfluid._fit_project, fluid, p1, p1,
                         pts, grad_p, k4, eps, t)
        out["tg_err"]["after_project"] = err(p2)
        out["loss"]["project"] = float(st_p.loss)
        out["div_rms"]["after_project"] = rms(
            tfluid._divergence_grid(fluid, p2, eps, t))
    n1 = fluid.wost_chunk
    p3, st_1 = timed("project_fit_one_chunk", tfluid._fit_project, fluid,
                     p1, p1, pts[:n1], grad_p[:n1], k4, eps, t)
    out["project_one_chunk"] = {"tg_err": err(p3),
                                "loss": float(st_1.loss), "points": n1}
    out["seconds"] = times
    if light:
        return out, None
    # the walk on the first points of the cloud, unmasked
    wp = pts[:walk_points]
    g_a, g_b, g_ref = timed("walk_stats", walk_estimates, fluid, wp, div,
                            k3.fold_in(0x5A11), fluid.walk_settings.n_walks,
                            ref_walks)
    out["walk"] = walk_stats(g_a, g_b, g_ref)
    out["walk"].update(points=int(wp.shape[0]),
                       n_walks=fluid.walk_settings.n_walks,
                       ref_walks=ref_walks)
    arrays = {"pts": wp, "div_grid": div, "g_a": g_a, "g_b": g_b,
              "g_ref": g_ref}
    return out, {k: v.detach().cpu().numpy() for k, v in arrays.items()}


def run_frames(fluid, params, t, args, name):
    """--frames: N steps from the checkpoint (see the module docstring)."""
    state = fluid.init_state(key=Key(args.seed))
    # NeuralFluid.add_source splits the key once before the steps
    key, _, _ = state.key.split(3)
    state = state._replace(params=params, timestep=t, key=key)
    rows = [tg_velocity_error(raw_velocity_grid(fluid, params, 1000))]
    for _ in range(args.frames):
        t0 = time.perf_counter()
        state = fluid.step(state)
        rows.append(tg_velocity_error(raw_velocity_grid(fluid, state.params,
                                                        1000)))
        print(f"step {state.timestep}: {time.perf_counter() - t0:.1f} s, "
              f"TG velocity error {rows[-1]:.6e}", flush=True)
    res = dict(curve_stats(rows), rows_all=rows, start_step=t,
               seed=args.seed, projection=fluid.projection, device=name)
    if args.curve_out:
        np.savetxt(args.curve_out, rows)
    print(json.dumps(res), flush=True)
    return res


def make_fluid(device, small=False, projection="wost"):
    kw = dict(device=device, projection=projection)
    if small:
        kw.update(max_n_iters=50, sample_resolution=16, wost_resolution=32,
                  div_resolution=64, n_walks=48, fit_pool=8)
    return tfluid.NeuralFluid(get_scene("taylorgreen"), **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nmcfluid_torch.sim.stageprobe")
    ap.add_argument("--ckpt", help="the checkpoint directory (model/)")
    ap.add_argument("--step", type=int)
    ap.add_argument("--keys", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="reduced sizes (and 64 walk points, 480 reference "
                         "walks), for a rehearsal on the CPU")
    ap.add_argument("--curve", default=None,
                    help="print the growth and mean of an error_ours.txt")
    ap.add_argument("--first", type=int, default=1,
                    help="with --curve: the first row (0-based) read")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--curve_out", default=None)
    ap.add_argument("--projection", default="wost",
                    choices=["wost", "spectral", "bem", "bvc"],
                    help="with --frames: the steps' pressure solve")
    args = ap.parse_args(argv)
    if args.curve:
        res = curve_stats(np.loadtxt(args.curve), args.first)
        print(json.dumps(res), flush=True)
        return res
    if args.projection != "wost" and not args.frames:
        ap.error("--projection goes with --frames (the stage split "
                 "reads the walk)")
    fluid = make_fluid(args.device, args.small, args.projection)
    like = fluid.init_state(0).params
    params, t = load_ckpt(args.ckpt, like, args.step)
    name = (torch.cuda.get_device_name(0) if fluid.device.type == "cuda"
            else "cpu")
    if args.frames:
        return run_frames(fluid, params, t, args, name)
    results = []
    for k in args.keys:
        res, arrays = probe_step(fluid, params, t, Key(k),
                                 *((64, 480) if args.small else ()))
        res.update(key=k, step=t, device=name)
        print(json.dumps(res), flush=True)
        results.append(res)
        if args.out and k == args.keys[0]:
            np.savez(args.out, step=t, key=k, **arrays)
    return results


if __name__ == "__main__":
    main()
