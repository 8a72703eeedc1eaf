"""The JAX package's readings of one Taylor-Green step by stage, from a
checkpoint: the counterpart of `python -m nmcfluid_torch.sim.stageprobe`.

    JAX_PLATFORMS=cpu python port_stages.py --ckpt DIR --step K \\
        [--keys 0 1] [--inputs STAGEPROBE.npz]

Loads `DIR/ckpt_step_tKKK.npz` (either package's checkpoint) and runs
step K + 1 of the shipped TG configuration with the JAX package
(nmcfluid) on the CPU, stage by stage, for each step key
(`jax.random.PRNGKey(k)` for k in --keys), printing one JSON line a key
with stageprobe's keys:

- `tg_err` before the step, after the advection fit (the shipped 10,000
  iterations on 64^2 batches; on the CPU the JAX package's fit_mode
  "auto" is its fresh-batch loop) and after a projection fit;
- `loss` of each fit; `div_rms` of the divergence grid (1000^2) of the
  advected field and of the projected one;
- the projection here fits one 65,536-point chunk of the pressure cloud
  against the JAX package's own grad p (a full 262,144-point walk is too
  slow on the CPU), so its readings are stageprobe's `project_one_chunk`;
- `walk`: the JAX package's gen walk on the first 1,024 points of the
  chunk with the advected field's divergence grid, 500 walks on two keys
  against an 8,000-walk estimate (points repeated, averaged), as
  stageprobe reads the port's walk.

With --inputs (stageprobe's --out file) the walk also runs on the port's
points and the port's divergence grid (`walk_port_inputs`), and the
port's own 500-walk estimate is held against the JAX package's reference
there (`port_vs_jax_ref`): the walk of the two packages on identical
inputs; --walk_only runs that comparison alone. This script imports JAX:
it is a check of the reference, not part of the port.

    JAX_PLATFORMS=cpu python port_stages.py --source_seed S --save DIR

instead runs the JAX package's add_source for the shipped TG
configuration from `init_state(S)` (as `python -m nmcfluid.run
taylorgreen --seed S` does; on the CPU its fit is the fresh-batch loop),
writes it as `DIR/ckpt_step_t000.npz` and prints its TG error: a
starting state of the JAX package's own for `stageprobe --frames`.
"""
import argparse
import json
import math
import os
import time

import numpy as np


def walk_stats_np(g_a, g_b, g_ref):
    d = g_a - g_ref
    return {"bias": d.mean(0).tolist(),
            "rms": float(np.sqrt(np.mean(np.sum(d ** 2, -1)))),
            "noise": float(np.sqrt(np.mean(np.sum((g_a - g_b) ** 2, -1)))
                           / math.sqrt(2.0)),
            "ref_rms": float(np.sqrt(np.mean(np.sum(g_ref ** 2, -1))))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt")
    ap.add_argument("--step", type=int)
    ap.add_argument("--source_seed", type=int, default=None,
                    help="run add_source from init_state(S) and --save it")
    ap.add_argument("--save", default=None)
    ap.add_argument("--keys", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--walk_only", action="store_true",
                    help="with --inputs: only the walk on the port's "
                         "points and divergence grid")
    ap.add_argument("--small", action="store_true",
                    help="reduced sizes (and 64 walk points, 480 reference "
                         "walks), for a rehearsal")
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim import fluid as jfluid
    from nmcfluid.transport.density import (raw_velocity_grid,
                                            tg_velocity_error)
    from nmcfluid.utils.checkpoint import load_ckpt, save_ckpt
    from nmcfluid.wost.gen import estimate_solution_and_gradient_gen

    kw = {}
    walk_points, ref_walks = 1024, 8000
    if args.small:
        walk_points, ref_walks = 64, 480
        kw = dict(max_n_iters=50, sample_resolution=16, wost_resolution=32,
                  div_resolution=64, n_walks=48)
    f = NeuralFluid(get_scene("taylorgreen"), **kw)
    scene = f.scene
    if args.source_seed is not None:
        t0 = time.perf_counter()
        state = f.add_source(f.init_state(args.source_seed))
        path = save_ckpt(args.save, state.params, 0)
        res = 1000 if not args.small else 64
        print(json.dumps({
            "tg_err": tg_velocity_error(np.asarray(
                raw_velocity_grid(f, state.params, res))),
            "seed": args.source_seed, "ckpt": path,
            "seconds": time.perf_counter() - t0, "device": "cpu (JAX)"}),
            flush=True)
        return
    params, t = load_ckpt(args.ckpt, f.init_state(0).params, args.step)
    params = jax.tree.map(jnp.asarray, params)
    eps, tt = float(scene.bdry_eps), t + 1
    n_walks = f.walk_settings.n_walks

    def err(p):
        return tg_velocity_error(np.asarray(raw_velocity_grid(f, p, 1000)))

    def div_grid(p):
        # in row blocks: the vmapped jacfwd of a 1000^2 grid at once would
        # hold every layer's tangents for 10^6 points
        from nmcfluid.sim import sampling
        pts = sampling.uniform_grid(scene.scene_size, f.div_resolution,
                                    False)

        def fn(x):
            return f.velocity(params=p, x=x, eps=eps, t=tt)
        jac = jax.jit(jax.vmap(jax.jacfwd(fn)))
        rows = [jnp.trace(jac(pts[i:i + 125].reshape(-1, 2)), axis1=-2,
                          axis2=-1).reshape(-1, pts.shape[1])
                for i in range(0, pts.shape[0], 125)]
        return -jnp.concatenate(rows)

    def rms(g):
        return float(np.sqrt(np.mean(np.asarray(g, np.float64) ** 2)))

    def walk(pts, grid, key):
        def est(p, k, n):
            return np.asarray(estimate_solution_and_gradient_gen(
                f._wost_scene, f.walk_settings, p, k, n_walks=n,
                source_args=(grid,))[1])
        g_a = est(pts, jax.random.fold_in(key, 1), n_walks)
        g_b = est(pts, jax.random.fold_in(key, 2), n_walks)
        reps = max(1, ref_walks // n_walks)
        g_ref = est(jnp.tile(pts, (reps, 1)), jax.random.fold_in(key, 3),
                    n_walks).reshape(reps, pts.shape[0], -1).mean(0)
        return g_a, g_b, g_ref

    inputs = np.load(args.inputs) if args.inputs else None
    if args.walk_only:
        key = jax.random.fold_in(jax.random.split(
            jax.random.PRNGKey(args.keys[0]), 5)[3], 0x5A11)
        t0 = time.perf_counter()
        g_a, g_b, g_ref = walk(jnp.asarray(inputs["pts"]),
                               jnp.asarray(inputs["div_grid"]), key)
        print(json.dumps({
            "walk_port_inputs": walk_stats_np(g_a, g_b, g_ref),
            "port_vs_jax_ref": walk_stats_np(inputs["g_a"], inputs["g_b"],
                                              g_ref),
            "port_ref_vs_jax_ref": walk_stats_np(
                inputs["g_ref"], inputs["g_ref"], g_ref),
            "seconds": time.perf_counter() - t0, "key": args.keys[0],
            "step": t, "device": "cpu (JAX)"}), flush=True)
        return
    for k in args.keys:
        times = {}
        t0 = time.perf_counter()
        key = jax.random.PRNGKey(k)
        _, k1, k2, k3, k4 = jax.random.split(key, 5)
        out = {"tg_err": {"before": err(params)}, "loss": {},
               "div_rms": {}}
        p1, st_a = jfluid._fit_advect(f, False, params, params, params,
                                      scene.dt, k2, eps, tt)
        out["tg_err"]["after_advect"] = err(p1)
        out["loss"]["advect"] = float(st_a.loss)
        times["advect_fit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        div = div_grid(p1)
        out["div_rms"]["before_project"] = rms(div)
        times["div_grid"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pts, valid, p, grad_p = jfluid._pressure_solve(
            f, f._wost_scene, (div,), jax.random.fold_in(k3, 0))
        times["wost_chunk0"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p3, st_p = jfluid._fit_project(f, p1, p1, pts, grad_p, k4, eps, tt)
        times["project_fit_one_chunk"] = time.perf_counter() - t0
        out["project_one_chunk"] = {"tg_err": err(p3),
                                    "loss": float(st_p.loss),
                                    "points": int(pts.shape[0])}
        out["div_rms"]["after_project"] = rms(div_grid(p3))
        t0 = time.perf_counter()
        wp = pts[:walk_points]
        out["walk"] = walk_stats_np(*walk(wp, div,
                                           jax.random.fold_in(k3, 0x5A11)))
        out["walk"].update(points=int(wp.shape[0]), n_walks=n_walks,
                           ref_walks=ref_walks)
        if inputs is not None and k == args.keys[0]:
            ip = jnp.asarray(inputs["pts"])
            ig = jnp.asarray(inputs["div_grid"])
            g_a, g_b, g_ref = walk(ip, ig, jax.random.fold_in(k3, 0x5A11))
            out["walk_port_inputs"] = walk_stats_np(g_a, g_b, g_ref)
            out["port_vs_jax_ref"] = walk_stats_np(
                inputs["g_a"], inputs["g_b"], g_ref)
            out["port_ref_vs_jax_ref"] = walk_stats_np(
                inputs["g_ref"], inputs["g_ref"], g_ref)
            out["div_grid_port_vs_jax"] = {
                "max_abs": float(np.max(np.abs(np.asarray(ig)
                                               - np.asarray(div))))}
        times["walk_stats"] = time.perf_counter() - t0
        out.update(seconds=times, key=k, step=t, device="cpu (JAX)")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
