"""Smoke run of the PyTorch port on one CUDA card (the H100 it targets).

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's CUDA kernels from nmcfluid_torch/csrc/ (one nvcc per
   source, all started together, for sm_90a), prints each build time and
   each fit kernel's registers, stack and spills (ptxas -v).
3. Drives the gather probe's entry point, nmcfluid_torch.wost.
   pallas_probe.main, at n = 65,536 (the probe's) and 524,288 (a walk
   generation's lanes), on a random table and on the radial table with
   the rows the walk's radius draw picks: each of the four kernels of
   csrc/gather.cu and each PyTorch baseline held exactly equal to
   table[idx] and timed; checks that each kernel launched; prints rows'
   launch, the launch plans of lanes and onehot and the copy yardstick (the
   marginal time of out.copy_(src), one streaming pass of n 16-byte
   rows) at each n.
4. Holds the persistent phase-fit kernel against its plain PyTorch twin on
   the card at Taylor-Green shapes (6 x 64 SIREN, 4096-point batches,
   K = 8 pools of three seeds) and against the twin in float64, checks
   that two calls agree bit for bit, and times it as the
   main path runs it: one 10,000-iteration fit on a K = 512 pool.
5. Holds the divergence grid and one walk-on-stars chunk on the card
   against the same stages on the CPU, on a small input.
6. Drives the main path at the shipped Taylor-Green width and depth:
   get_scene, NeuralFluid(device="cuda"), init_state, add_source and one
   step (TG_STEPS), with the per-stage wall-clock (and the fit kernel's own device
   time, "fit_kernel") and the Taylor-Green velocity error of each step,
   and checks that every phase fit ran on the kernel, one launch a fit;
   then one step from docs/tg_stage_ckpt (the port's seed 1 after step
   10), stage by stage, each stage's added error held to the JAX
   package's from the same state (tg_stage_check).
7. The paths of PATHS, each through path_phase: steps 4 and 5 at the
   scene's shapes (the float64 twin beside the f32 one; a 24^3 grid for
   the small input in 3D), then get_scene, NeuralFluid(device="cuda"),
   init_state, add_source and the steps at the shipped width: karman (2 x
   128 SIREN, the channel with its circle, the ramp width halved after
   add_source as the JAX CLI does; one step whose walk is cut in depth to
   one 65,536-point pressure chunk, 256^2 points where the shipped step
   walks 512^2 in four chunks at ~244 s, to keep the phases under 900 s),
   jpipe (2 x 128, the walk over its
   segment soup, the ramp kept, one step whose walk is cut to one
   65,536-point chunk as karman's, a 1000^2 grid; its fit check
   needs pool points with an off-diagonal A and holds the float64 twin at
   ATOL64, as karman3d's, its small-input walk nine points in ten at the
   gen tolerance), then the 3D scenes in the closed cube:
   smoke (5 x 64), karman3d (2 x 128), smoke_obs and
   vortex_collide (5 x 64), one step each, with an 80^3 divergence grid
   and 256^2 pressure points; all with 500 walks, 10,000-iteration fits
   on K = 512 pools with fresh weights each. Per path: stage times, walk
   counts, one fit-kernel launch a fit, P, kinetic energy, the source
   fit's error against the mean source and 0.5 mean|u|^2 after the steps
   on the scene's vel_vis grid, over the points where the hard BCs pin
   nothing, each within its bound, peak memory.
8. The projections phase (PROJECTIONS): one step of a path under a
   deterministic projection from the path's own add_source state (the
   source fit does not depend on the projection): Taylor-Green and karman
   under bem and spectral, jpipe under bem, the four 3D scenes under
   spectral. Each first holds the projection of one divergence grid at
   the same points on the card against the CPU (p and grad p within
   PROJECTION_TOL of their magnitude), then steps at full width: one
   fit-kernel launch a fit, the stage times (spectral_solve or bem_solve,
   the BEM's host precompute apart as bem_precompute, and the BEM solve
   split by part with CUDA events), peak memory, a finite P, and the
   path's band (the TG error bound, else the energy ratio of step 7).
9. The walks phase (walks_phase): (a) the walker pool against the
   generation executor on one 65,536-point Taylor-Green chunk at 500
   walks, on the same streams (equal valid counts, p and grad p at
   tests/test_gen.py's tolerances; each executor's seconds, the pool's
   trips); (b) the screened mixed Dirichlet/Neumann problem and the
   double-sided barrier under estimate_solution and the gen and pool
   gradients, at the JAX tests' atol, and a small input on the card
   against the CPU; (c) an image-driven scene built from PFMs written to
   a temporary directory, held to its manufactured solution; (d) the bvc
   projection held card against CPU on small Taylor-Green and karman
   inputs, then one Taylor-Green step under bvc at full width from the
   path's add_source state: one fit-kernel launch a fit, the cache walk
   and the splat timed apart by CUDA events (bvc_walk, bvc_splat), peak
   memory and the TG error bound; then karman's: the small input card
   against CPU and one step under bvc at full width from karman's
   add_source state (projection_phase, as step 8: the shipped net,
   128^2 batches, 10,000-iteration fits, 500 walks, the cache walk in
   generations of BVC_GROUP_PAIRS pairs; one fit-kernel launch a fit, the
   stage times bvc_walk, bvc_splat and the fits, the cache walk's
   generations and steps, the energy ratio within karman's band) and the
   seconds it adds.
10. The soups-and-sources phase (soups_phase): (a) every query of
   geometry/queries3d.py on the card against the CPU, on the cube and the
   reflex soup; (b) tests/test_mixed3d.py's mixed problem and
   double-sided barrier on triangle soups under estimate_solution and the
   gen and pool gradients, at the JAX tests' atol; (c) one full-width
   smoke step walked on the 12-triangle cube soup from smoke's add_source
   state, held point by point to the smoke path's step on the analytic
   cube (the same walk inputs), with its P, energy ratio and walk
   seconds; (d) one full-width Taylor-Green step under wost_source "net"
   from TG's add_source state (its walk cut to one 65,536-point chunk),
   its stage times and the TG error bound, after the net source itself
   and a small net-source walk held card against CPU; (e) a ["cuda:0",
   "cuda:0"] points mesh against the meshless solve on 65,536 TG points
   (MESH_WALKS walks) in two 32,768-point chunks, one a device, bit for
   bit.
11. The baselines-and-tools phase (baselines_phase): (a) each comparison
   baseline's loss (INSR's source, advect, pressure and project; PINN;
   PI-DeepONet) and its gradient by the weights at 3 x 256 on 1,024
   points, card against CPU on the same weights and draws, within
   BASELINE_TOL of the magnitude; (b) the shipped widths cut in depth:
   INSR's source fit and one step on 128^2 points at INSR_ITERS
   iterations a phase (shipped 20,000), then PINN and PI-DeepONet through
   nmcfluid_torch.baselines.run.main at TRAIN_ITERS iterations (shipped
   50,000) with a BASELINE_GRID^2 error grid (shipped 1000^2), each
   phase's ms an iteration by CUDA events, the error files written and
   finite, the source loss falling; (c) one frame of the oracle floor
   (tools_oracle_floor) at Taylor-Green's shipped width: add_source and
   two source fits, three fit-kernel launches counted, the TG error
   finite and under ORACLE_BOUND.
12. The executors phase (executors_phase): (a) one Taylor-Green pressure
   solve under walk_algo "lockstep" (fastrand) at 500 walks on a
   65,536-point chunk, held against the pool on the same points as an
   independent realization of one estimator: its mean |dp| and
   |d grad p| against the pool within EXEC_RATIO x the pool's against
   itself on another key; (b) the threefry lockstep (fast_rng=False) on
   the mixed box and the adaptive pool on tests/test_pool.py's obstacle
   scene, card against CPU on the same streams, the adaptive run's walks
   against the fixed run's; (c) one Taylor-Green source fit with
   fit_ensemble 2 at the shipped depth: two fit-kernel launches counted
   and timed by CUDA events, the first launch's inputs held kernel
   against twin, its parameters the mean of the two single fits within
   ENSEMBLE_ATOL; (d) tools_walk_roofline and tools_fit_microbench in
   --quick mode.

Any failed check raises, so the script exits non-zero. The last three
lines are the kernel report ({"kernels": [...]}, one entry per kernel with
its launches, error, times and bound; the fit kernel has one entry per
path: taylorgreen, karman, jpipe, smoke, karman3d, smoke_obs,
vortex_collide, the CLI's two runs, the nine projection paths,
Taylor-Green and karman under bvc, smoke on the cube soup, Taylor-Green
under the net source, the oracle floor and Taylor-Green's fit under
fit_ensemble 2, two launches a fit),
the card's name and power limit as nvidia-smi gives them, and {"ok":
true, "device": {...}}.
"""
import json
import os
import re
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

GATHER_N = (65536, 524288)     # the probe's n; a walk generation's lanes


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync():
    torch.cuda.synchronize()


POOL_SEEDS = (0, 1, 2)


def check_fit_kernel(fluid, fk, tfluid, params, atol, need_offdiag=False,
                     atol64=None):
    """Kernel vs plain twin on K = 8 pools of the scene's shapes, one for
    each of POOL_SEEDS, 25 iterations at lr 1e-3: params to rtol 2e-4 /
    `atol` (1e-3 at Taylor-Green, else PATHS's) and loss to rtol 1e-2; a
    second call must agree bit for bit; the kernel is held to the twin in
    float64 at `atol64` (default `atol`), and both distances from float64
    are printed, with the pool points whose hard-BC map A has off-diagonal
    entries (jpipe's elbow; need_offdiag requires some). Then the kernel
    as the main path runs it: a max_n_iters fit on a K = fit_pool pool
    with the main path's lr. Returns (max_abs_err, kernel ms/iter, twin
    ms/iter)."""
    from nmcfluid_torch.sim.fitprobe import scene_pool
    cfg = fluid.siren_cfg
    err = 0.0
    for seed in POOL_SEEDS:
        pool = scene_pool(fluid, 8, seed=seed)
        A = pool[1]
        eye = torch.eye(A.shape[-1], device=A.device)
        n_off = int(((A * (1 - eye)).abs().amax(dim=(-1, -2)) > 0).sum())
        if need_offdiag and n_off == 0:
            raise AssertionError(f"{fluid.scene.name} pool seed {seed}: no "
                                 f"point with an off-diagonal A")
        p_k, l_k = fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)
        p_k2, l_k2 = fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)
        _sync()
        t0 = time.perf_counter()
        p_r, l_r = fk.reference_adam_fit(params, cfg, pool, 25, 1e-3)
        _sync()
        plain_ms = (time.perf_counter() - t0) * 1e3 / 25
        p_d, _ = fk.reference_adam_fit(
            [(W.double(), b.double()) for W, b in params], cfg,
            tuple(t.double() for t in pool), 25, 1e-3)
        err_s = err_k64 = err_r64 = 0.0
        for (a, b), (c, d), (e, f), (g, h) in zip(p_k, p_r, p_k2, p_d):
            for u, v, w, x in ((a, c, e, g), (b, d, f, h)):
                torch.testing.assert_close(u, v, rtol=2e-4, atol=atol)
                torch.testing.assert_close(u.double(), x, rtol=2e-4,
                                           atol=atol64 or atol)
                err_s = max(err_s, float((u - v).abs().max()))
                err_k64 = max(err_k64, float((u.double() - x).abs().max()))
                err_r64 = max(err_r64, float((v.double() - x).abs().max()))
                if not torch.equal(u, w):
                    raise AssertionError("two fit-kernel calls differ")
        if not torch.equal(l_k, l_k2):
            raise AssertionError("two fit-kernel calls give other losses")
        rel = abs(float(l_k) - float(l_r)) / abs(float(l_r))
        if not rel <= 1e-2:
            raise AssertionError(f"fit loss: kernel {float(l_k)} vs twin "
                                 f"{float(l_r)}")
        err = max(err, err_s)
        print(f"{fluid.scene.name} pool seed {seed}: fit kernel vs twin "
              f"{err_s:.3e}; kernel and twin against the float64 twin "
              f"{err_k64:.3e} and {err_r64:.3e} (atol {atol:g}, float64 "
              f"{atol64 or atol:g}); {n_off} "
              f"of {A.shape[0] * A.shape[1]} points with an off-diagonal A",
              flush=True)
    # the main path's fit: K = fit_pool pool, max_n_iters iterations, its lr
    pool = scene_pool(fluid, fluid.fit_pool, seed=1)
    lr = tfluid._fit_lr_array(fluid)
    n = fluid.max_n_iters
    fk.fused_adam_fit(params, cfg, pool, 20, lr)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    fk.fused_adam_fit(params, cfg, pool, n, lr)
    ev1.record()
    _sync()
    kernel_ms = ev0.elapsed_time(ev1) / n
    del pool
    torch.cuda.empty_cache()
    print(f"{fluid.scene.name} fit kernel vs twin: max_abs_err {err:.3e} "
          f"over pool seeds {POOL_SEEDS} (atol {atol:g}), repeats "
          f"bit-identical; ms/iter kernel {kernel_ms:.5f} ({n} "
          f"iterations, K = {fluid.fit_pool}), twin {plain_ms:.4f}",
          flush=True)
    return err, kernel_ms, plain_ms


def fit_build_report(log, plan, threads):
    """Each fit kernel's registers, stack and spills from ptxas -v, and the
    dynamic shared memory the plan gives it at Taylor-Green shapes."""
    kernels, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*fit_persistentILi(\d)"
                      r"ELb([01])ELi(\d)E\S*)'", line)
        if m:
            cur = {"npw": int(m.group(2)), "recompute": m.group(3) == "1",
                   "pass_tiles": int(m.group(4))}
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    if not kernels:
        raise AssertionError("no fit kernel in the ptxas report")
    for k in sorted(kernels, key=lambda k: (k["recompute"], k["npw"],
                                            k["pass_tiles"])):
        print(f"fit_persistent<H padded to {32 * k['npw']}, "
              f"{'recompute' if k['recompute'] else 'store'}, "
              f"{k['pass_tiles']} tiles a pass>: "
              f"{k.get('registers')} registers, {k.get('stack')} B stack, "
              f"{k.get('spill_stores')} B spill stores, "
              f"{k.get('spill_loads')} B spill loads", flush=True)
    print(f"fit kernel at Taylor-Green shapes: {plan.G} blocks x "
          f"{threads} threads, {plan.smem_bytes} B dynamic shared memory a "
          f"block", flush=True)
    return kernels


def _walk_close(name, got, want, spread, rtol, atol, share):
    """Every point at (rtol, atol) when share is 1; else at least `share`
    of them, and the others within four times the walk's spread (the RMS
    difference of two keys' estimates over sqrt 2). On a segment soup a
    walker on a wall decides whether that wall's end vertices are
    silhouettes by the sign of a rounding error, so an ulp of another sum
    order sends a few walks elsewhere on either device
    (tests/test_torch_jpipe.py::_walk_close)."""
    diff = (got - want).abs()
    close = (diff <= atol + rtol * want.abs()).reshape(diff.shape[0], -1)
    close = close.all(-1)
    if share >= 1.0:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        return
    far = diff.reshape(diff.shape[0], -1)[~close]
    frac = float(close.float().mean())
    if not (frac >= share and bool((far <= 4.0 * spread).all())):
        raise AssertionError(f"{name}: {frac:.3f} of the points within the "
                             f"gen tolerance (need {share}), the others up "
                             f"to {float(far.max()):.3e} (4 x the walk's "
                             f"spread {spread:.3e})")


def check_small_input(tfluid, scene, Key, eps, div_resolution=64):
    """The divergence grid and one WoSt chunk on the card against the same
    stage on the CPU, on a small input with the same keys, at ramp width
    eps. On a segment soup (jpipe) nine points in ten are held at the gen
    tolerance and the rest within the walk's noise (_walk_close)."""
    kw = dict(sample_resolution=16, wost_resolution=16,
              div_resolution=div_resolution, n_walks=48, max_n_iters=50,
              fit_pool=8)
    gpu = tfluid.NeuralFluid(scene, device="cuda", **kw)
    cpu = tfluid.NeuralFluid(scene, device="cpu", **kw)
    params = gpu.init_state(3).params
    params_cpu = [(W.cpu(), b.cpu()) for W, b in params]
    div_g = tfluid._divergence_grid(gpu, params, eps, 1)
    div_c = tfluid._divergence_grid(cpu, params_cpu, eps, 1)
    torch.testing.assert_close(div_g.cpu(), div_c, rtol=1e-4, atol=5e-5)
    pts_g, val_g, p_g, g_g = tfluid._pressure_solve(gpu, (div_g,), Key(11))
    pts_c, val_c, p_c, g_c = tfluid._pressure_solve(cpu, (div_g.cpu(),),
                                                    Key(11))
    torch.testing.assert_close(pts_g.cpu(), pts_c, rtol=2e-7, atol=0)
    if not torch.equal(val_g.cpu(), val_c):
        raise AssertionError("valid flags of the pressure cloud differ")
    from nmcfluid_torch.geometry.soup2d import Seg2D
    soup = isinstance(scene.boundary, Seg2D)
    share, spread_p, spread_g = 1.0, 0.0, 0.0
    if soup:
        _, _, p_c2, g_c2 = tfluid._pressure_solve(cpu, (div_g.cpu(),),
                                                  Key(12))
        share = 0.9
        spread_p = float((p_c - p_c2).pow(2).mean().sqrt()) / 2 ** 0.5
        spread_g = float((g_c - g_c2).pow(2).mean().sqrt()) / 2 ** 0.5
    # gen tolerances (tests/test_gen.py): same streams, other sum order
    _walk_close(f"{scene.name} p", p_g.cpu(), p_c, spread_p, 2e-4, 2e-5,
                share)
    _walk_close(f"{scene.name} grad p", g_g.cpu(), g_c, spread_g, 2e-3,
                2e-4, share)
    print(f"{scene.name} small input: divergence grid "
          f"{tuple(div_g.shape)} and WoSt chunk on the card match the CPU"
          + (" (nine points in ten at the gen tolerance, the rest within "
             "the walk's noise)" if soup else ""), flush=True)


def _fit_bound(cfg, B):
    """Least time of one Adam iteration at batch B (fitkernel.
    iteration_work), at the published peaks (700 W): (bound_ms, bound_by)
    at the f32 rate, and the 3xTF32 bound: three TF32 products for each
    f32 one on the tensor cores."""
    from nmcfluid_torch.sim.fitkernel import iteration_work
    from nmcfluid_torch.utils import h100
    n_bytes, flops = iteration_work(cfg, B)
    return h100.bound_ms(n_bytes, flops) + (
        h100.bound_ms(n_bytes, 3 * flops, h100.TF32_FLOPS)[0],)


def _gather_bound(idx):
    """All four forms compute out[b] = table[idx[b]], so one bound: indices
    read and rows written once, and the table rows this run's indices
    touch. (What a form does beyond that, such as onehot's sort and its
    reads of the whole table from L2, is the form's cost, not the
    function's.)"""
    from nmcfluid_torch.utils import h100
    return h100.bound_ms(20 * idx.shape[0] + 16 * torch.unique(idx).numel(),
                         0)


# the one-call PyTorch forms of out = table[idx] that the probe times
LIBRARY_CALLS = {"torch": "torch.index_select(table, 0, idx)",
                 "torch_rows": "table[idx]",
                 "torch_lanes": "table.T[:, idx].T"}


def gather_report(pp, probe, launches):
    """Kernel-report entries of the four gathers at n = GATHER_N[-1] on the
    random table, all from the probe's runs but the relayout: the kernel's
    time, its plain version's, the fastest one-call PyTorch form's (named
    in `library_call`), the largest error over every run, and the bound
    from the run's indices; onehot's entry adds the time of its table's
    relayout, made once per table."""
    n = GATHER_N[-1]
    res = probe[("random", n)]
    table, idx = pp.probe_inputs("random", n, "cuda")
    bound_ms, bound_by = _gather_bound(idx)
    lib = min(LIBRARY_CALLS, key=lambda f: res[f]["ms"])
    relayout_ms = pp.marginal_ms(lambda k: [
        pp._kernel_table(table, "onehot") for _ in range(k)])
    n_sm = pp._sm_count(idx.device)
    for n_k in GATHER_N:
        rows_blocks = -(-n_k // (pp.ROWS_G * pp.ROWS_NT))
        print(f"gather plans at n = {n_k}: rows {rows_blocks} blocks of "
              f"{pp.ROWS_NT} threads x {pp.ROWS_G} rows (fixed); "
              f"{pp.lanes_plan(n_k, table.shape[0], n_sm)}; "
              f"{pp.onehot_plan(n_k, n_sm)}; copy yardstick "
              f"{probe[('random', n_k)]['copy']['ms']:.5f} ms (radial "
              f"{probe[('radial', n_k)]['copy']['ms']:.5f}), "
              f"out.copy_(src) of ({n_k}, 4) float32", flush=True)
    lines = {"rows": 38, "lanes": 44, "scalar": 52, "onehot": 59}
    out = []
    for variant in pp.VARIANTS:
        ms = res[variant]["ms"]
        out.append({
            "name": f"gather_{variant}_k", "route": "cuda",
            "source": "nmcfluid_torch/csrc/gather.cu",
            "replaces": f"nmcfluid/wost/pallas_probe.py:{lines[variant]}",
            "launches": launches[variant],
            "max_abs_err": max(r[variant]["err"] for r in probe.values()),
            "ms": ms, "plain_ms": res[pp.PLAIN[variant]]["ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": res[lib]["ms"], "library_call": LIBRARY_CALLS[lib],
            "n": n})
        if variant == "onehot":
            out[-1]["relayout_ms"] = relayout_ms
        print(f"gather {variant}: {ms:.5f} ms kernel ({bound_ms / ms:.1%} "
              f"of the bound {bound_ms:.5f} ms, {bound_by}), "
              f"{out[-1]['plain_ms']:.5f} ms plain, {res[lib]['ms']:.5f} "
              f"ms {LIBRARY_CALLS[lib]} (kernel {ms / res[lib]['ms']:.2f}x "
              f"it) at n = {n}"
              + (f"; the table's relayout {relayout_ms:.5f} ms, once a "
                 f"table" if variant == "onehot" else ""), flush=True)
    return out


def _fit_entry(path, fluid, launches, per_frame, err, kernel_ms, plain_ms):
    """The kernel report's entry of the fit kernel on one path, with its
    bound at the path's shapes."""
    bound_ms, bound_by, bound_tc_ms = _fit_bound(fluid.siren_cfg,
                                                 fluid.n_batch)
    print(f"{path} fit kernel: {kernel_ms:.5f} ms/iter, "
          f"{bound_ms / kernel_ms:.1%} of the f32 bound ({bound_ms:.5f} ms), "
          f"{bound_tc_ms / kernel_ms:.1%} of the 3xTF32 bound "
          f"({bound_tc_ms:.5f} ms); "
          + (f"{per_frame} launches a frame" if per_frame is not None
             else "no step on this path"), flush=True)
    return {
        "name": "fit_persistent (fused_adam_fit)", "route": "cuda",
        "source": "nmcfluid_torch/csrc/fitkernel.cu",
        "replaces": "nmcfluid/sim/fitkernel.py:318", "path": path,
        "launches": launches, "launches_per_frame": per_frame,
        "max_abs_err": err, "ms": kernel_ms, "ms_per": "Adam iteration",
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_3xtf32_ms": bound_tc_ms,
        # no single PyTorch call computes an Adam iteration of a SIREN
        "library_ms": None}


def _walk_report(wost_s, stage="wost_solve"):
    """The walk's generations, steps and lanes since the counts were
    zeroed, and the solve's (`stage`'s) seconds split by step; zeroes
    them."""
    from nmcfluid_torch.wost import gen
    c = dict(gen.counts)
    gen.counts.update(dict.fromkeys(gen.counts, 0))
    return (f"walk: {c['generations']} generations, {c['steps']} steps "
            f"({c['steps'] / max(1, c['generations']):.1f} a generation), "
            f"{c['lane_steps'] / max(1, c['steps']):.0f} active lanes a "
            f"step on average, {wost_s * 1e3 / max(1, c['steps']):.3f} ms "
            f"of {stage} a step")


def _check_finite(state, projection):
    pts, p, grad_p, div = projection
    for name, t in [("P", state.P), ("p", p), ("grad_p", grad_p),
                    ("div_grid", div)] + [
                        (f"param{i}", a) for i, pair in
                        enumerate(state.params) for a in pair]:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")


def _plan(fk, fluid):
    cfg = fluid.siren_cfg
    return fk.fit_plan(cfg.in_features, cfg.out_features,
                       cfg.hidden_features, cfg.num_hidden_layers,
                       fluid.n_batch, fluid.fit_pool, fluid.max_n_iters,
                       fk._sm_count(torch.device("cuda")))


# the Taylor-Green path's steps at full width (one since the walks phase
# came: the phases stay under 900 s; the CLI phase reads step 1)
TG_STEPS = 1


def taylor_green_phase(cuda_build):
    """The fit kernel and the small input at Taylor-Green shapes, then the
    Taylor-Green path at full width and depth: add_source + 1 step, 3
    fit-kernel launches. Returns the fit kernel's report entry, the params
    after step 1, the TG velocity errors after add_source and each step,
    and the state after add_source."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.transport.density import (raw_velocity_grid,
                                                  tg_velocity_error)
    from nmcfluid_torch.utils.keys import Key

    scene = get_scene("taylorgreen")
    fluid = tfluid.NeuralFluid(scene, device="cuda")
    fit_build_report(cuda_build.build_log("fitkernel", fk._SOURCES),
                     _plan(fk, fluid), fk._NT)
    err, kernel_ms, plain_ms = check_fit_kernel(
        fluid, fk, tfluid, fluid.init_state(1).params, atol=1e-3)
    check_small_input(tfluid, scene, Key, scene.bdry_eps)

    def tg_error(params):
        """TG velocity error on the raw 1000^2 grid. The untrained field
        reads ~0.5; fits at the shipped depth read 2e-5 to 6e-4 over seeds
        (PERF.md), so 5e-3 is a bound only a broken fit crosses."""
        err_tg = tg_velocity_error(raw_velocity_grid(fluid, params, 1000))
        if not err_tg < 5e-3:
            raise AssertionError(f"TG velocity error {err_tg} >= 5e-3")
        return err_tg

    # ---- the main path at full width
    fk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fluid.init_state(0)
    state = fluid.add_source(state)
    _sync()
    wall = time.perf_counter() - t0
    errors = [tg_error(state.params)]
    source = state
    print(f"add_source: {wall:.2f} s, TG velocity error {errors[0]:.6e}",
          flush=True)
    fluid.profile = True
    per_frame = []
    for s in range(TG_STEPS):
        fluid.stage_times = {}
        _walk_report(0.0)
        before = fk.launches
        t0 = time.perf_counter()
        state = fluid.step(state)
        _sync()
        wall = time.perf_counter() - t0
        per_frame.append(fk.launches - before)
        if s == 0:
            step1 = [(W.clone(), b.clone()) for W, b in state.params]
        errors.append(tg_error(state.params))
        stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
        print(f"step {s + 1}: {wall:.2f} s, stages {json.dumps(stages)}, "
              f"fit-kernel launches {per_frame[-1]}, P "
              f"{float(state.P):.6e}, TG velocity error "
              f"{errors[-1]:.6e}; "
              f"{_walk_report(stages['wost_solve'])}", flush=True)
    launches = fk.launches
    if launches != 1 + 2 * TG_STEPS or per_frame != [2] * TG_STEPS:
        raise AssertionError(f"expected {1 + 2 * TG_STEPS} fit-kernel "
                             f"launches (1 source + "
                             f"2 per step), got {launches} ({per_frame} "
                             f"in the steps)")
    _check_finite(state, fluid._last_projection)
    _, p, _, div = fluid._last_projection
    if tuple(div.shape) != (1000, 1000) or tuple(p.shape) != (512 * 512,):
        raise AssertionError(f"shapes: div {tuple(div.shape)}, p "
                             f"{tuple(p.shape)}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    tg_stage_check(fluid)
    return (_fit_entry("taylorgreen", fluid, launches, per_frame[0], err,
                       kernel_ms, plain_ms), step1, errors, source)


# The 2 x 128 nets' fits against the float64 twin: float32 itself (the
# f32 twin) leaves float64 by up to 2.0e-5 over keys 0-11 of the initial
# weights, and the kernel by up to 1.4e-5 (karman), 1.9e-5 (jpipe) and
# 1.8e-5 (karman3d); each bound is 1.25 x the kernel's most, rounded up
# at the second digit (sim/fitprobe.py SMOKE_ATOL, with the bound against
# the f32 twin, 1.2e-5 on karman3d, where the kernel reads up to 9.5e-6).
# At these bounds TF32 weight-gradient operands read 11 x them and more
# and one partial row left out 389 x at every key; fast sincos reads
# within the kernel's own spread (0.1-0.46 x the bounds at its least)
# and fails the check at 3 (jpipe), 8 (karman) and 3 (karman3d) of 12
# keys (`python -m nmcfluid_torch.sim.fitprobe --key_sweep 12`, PERF.md
# section 6).
ATOL64 = {"karman": 1.8e-5, "jpipe": 2.4e-5, "karman3d": 2.3e-5}


# The JAX package's readings of one Taylor-Green step from the port's
# seed-1 state after step 10 (docs/tg_stage_ckpt), on the CPU, keys 0 and
# 1 of `JAX_PLATFORMS=cpu python port_stages.py --ckpt docs/tg_stage_ckpt
# --step 10`: the TG error before the step, after the advection fit and
# after the projection fit on one 65,536-point chunk (PERF.md §2).
JAX_STAGE_READINGS = {"before": 2.7016533e-4,
                      "after_advect": (2.7729218e-4, 2.7566643e-4),
                      "project_one_chunk": (3.0735043e-4, 3.0369643e-4)}


def tg_stage_readings(fluid, key):
    """One Taylor-Green step from docs/tg_stage_ckpt on the card, stage by
    stage (sim/stageprobe.py::probe_step, light: the advection fit, one
    chunk's walk, the projection fit on it) on `key`: the error the
    advection fit adds and the error the whole step adds, each over the
    JAX package's mean over its two keys from the same state. Raises if
    the checkpoint's error before the step is not the JAX package's."""
    from nmcfluid_torch.sim import stageprobe
    from nmcfluid_torch.utils.checkpoint import load_ckpt
    params, t = load_ckpt("docs/tg_stage_ckpt", fluid.init_state(0).params,
                          10)
    res, _ = stageprobe.probe_step(fluid, params, t, key, light=True)
    before = res["tg_err"]["before"]
    if abs(before - JAX_STAGE_READINGS["before"]) > 1e-3 * before:
        raise AssertionError(f"TG stage check: the checkpoint reads {before}"
                             f", the JAX package {JAX_STAGE_READINGS['before']}")
    got = {"after_advect": res["tg_err"]["after_advect"] - before,
           "project_one_chunk": res["project_one_chunk"]["tg_err"] - before}
    return {name: (delta, sum(v - JAX_STAGE_READINGS["before"]
                              for v in JAX_STAGE_READINGS[name]) / 2)
            for name, delta in got.items()}


def tg_stage_check(fluid):
    """tg_stage_readings on Key(0): each added error within [0.5, 2] x the
    JAX package's. The port's 50-frame Taylor-Green curves once read as
    its step adding 3-6 x JAX's error a frame; from the same state it adds
    what JAX's adds (PERF.md §2), and a step that added 3 x would fail
    here."""
    from nmcfluid_torch.utils.keys import Key
    for name, (delta, jax_delta) in tg_stage_readings(fluid, Key(0)).items():
        print(f"TG stage check, {name}: the port's step adds {delta:.4e} to "
              f"the error, the JAX package's {jax_delta:.4e} "
              f"({delta / jax_delta:.2f} x; band [0.5, 2])", flush=True)
        if not 0.5 * jax_delta <= delta <= 2.0 * jax_delta:
            raise AssertionError(f"TG stage check, {name}: {delta} vs "
                                 f"the JAX package's {jax_delta}")


# the paths after Taylor-Green: (scene, steps, fit-kernel atol, the fit
# plan's (recompute, weight buffers, tiles a block, tiles a pass), bound
# on the source fit's relative squared error, band on the energy ratio
# after the steps).
# Both readings are taken over the free region (free_region), where a
# network that outputs zero reads an error of 1 and a ratio of 0 and so
# crosses both bounds; the untrained network reads errors of 1.01 / 537 /
# 1.01 / 22.6 / 8.8 and crosses the first; the JAX package's CPU run of
# each scene (port_bounds.py) passes both: errors 3.8e-4 / 0.068 / 3.5e-4
# / 0.082 / 0.061, ratios after a step 0.996 / 1.39 / 0.974 / 0.372 / 0.61
# (karman / smoke / karman3d / smoke_obs / vortex_collide; PERF.md §2).
# jpipe's bounds are karman's: the JAX package's run reads an error of
# 0.018 and a ratio of 0.96 after a step, the untrained network 1.01 and
# 0.017, the zero network 1 and 0 (`port_bounds.py jpipe`).
# The atols: the smoke family's 1e-3 (sim/fitprobe.py); for the 2 x 128
# nets sim/fitprobe.py's SMOKE_ATOL against the f32 twin (1e-5, karman3d
# 1.2e-5; see ATOL64).
# The last field is the pressure cloud's side (None: the scene's): karman's
# shipped step walks 512^2 points in four 65,536-point chunks, ~244 s of
# walk tail, so its step here walks one such chunk (256^2) to keep the
# phases under 900 s; jpipe's (~63 s of walk in four chunks) walks one
# chunk too since the executors phase came, to keep them under 810 s.
# With only these two cut the phases read 879.9 s on an H100 whose host
# ran the walk 1.4x slower than another's, so the net-source step and
# the CLI's fresh-batch run walk one chunk and the mesh check 100 walks
# (PERF.md section 6).
PATHS = (
    ("karman", 1, 1e-5, (False, 1, 4, 1), 5e-2, (0.5, 2.0), 256),
    ("jpipe", 1, 1e-5, (False, 1, 4, 1), 5e-2, (0.5, 2.0), 256),
    ("smoke", 1, 1e-3, (False, 1, 4, 2), 0.5, (0.25, 2.0), None),
    ("karman3d", 1, 1.2e-5, (False, 1, 4, 1), 5e-2, (0.5, 2.0), None),
    ("smoke_obs", 1, 1e-3, (False, 1, 4, 2), 0.5, (0.25, 2.0), None),
    ("vortex_collide", 1, 1e-3, (False, 1, 4, 2), 0.5, (0.25, 2.0), None),
)


# the paths whose last step the soups phase walks again on a triangle
# soup, and what path_phase keeps of that step: its projection (pts, p,
# grad p, divergence grid), P, energy ratio and walk seconds
SOUP_PATHS = ("smoke",)
PATH_RUNS = {}


def free_region(fluid, grid, n_keys=64):
    """(free, src) on `grid`: free marks the fluid points where the hard
    BCs pin no component (c == 0 in u = A raw + c at the scene's ramp
    width), so that the field there is the network's; src is the
    source's mean over the keys 0..n_keys-1 of its jitter (smoke's jet
    draws one, the other sources draw nothing). port_bounds.py takes the
    JAX package's readings the same way."""
    from nmcfluid_torch.utils.keys import Key
    scene = fluid.scene
    _, c = fluid.velocity_affine(grid, eps=scene.bdry_eps, t=0)
    free = scene.fluid_mask(grid) & (c == 0).all(-1)
    src = sum(scene.source_velocity(grid, key=Key(k))
              for k in range(n_keys)) / n_keys
    return free, src


def path_phase(name, n_steps, atol, plan_mode, err_bound, band,
               wost_resolution=None):
    """The fit kernel and the small input at a scene's shapes, then its
    path at full width: add_source, the ramp width the scene steps with
    (halved in the 2D karman family as the JAX CLI does, nmcfluid/run.py:
    498-500; SceneSpec.eps_after_source), and n_steps
    steps (512^2 pressure points and a 1000^2-cell divergence grid in 2D,
    256^2 and 80^3 in 3D, x 500 walks; 10,000-iteration fits on K = 512
    pools with fresh weights each). Checks one fit-kernel launch a fit,
    and on the scene's vel_vis grid, over the free region (free_region:
    where the hard BCs pin nothing), the source fit's relative squared
    error against the mean source (< err_bound) and 0.5 mean|u|^2 after
    the steps within `band` x the mean source's. wost_resolution, where
    given, sets the pressure cloud's side in place of the scene's.
    Returns the fit kernel's report entry and the state after
    add_source."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.sim.sampling import grid_resolutions, uniform_grid
    from nmcfluid_torch.utils.keys import Key

    scene = get_scene(name)
    fluid = tfluid.NeuralFluid(scene, device="cuda",
                               wost_resolution=wost_resolution)
    plan = _plan(fk, fluid)
    if (plan.recompute, plan.n_wbuf, plan.tiles_per_block,
            plan.pass_tiles) != plan_mode:
        raise AssertionError(f"{name} fit plan {plan}")
    print(f"fit kernel at {name} shapes: {plan.G} blocks x {fk._NT} "
          f"threads, {plan.tiles_per_block} tiles a block, "
          f"{plan.pass_tiles} a pass ({'4 x 4' if plan.wide else '2 x 4'} "
          f"micro-tiles), store mode, {plan.n_wbuf} weight buffers, "
          f"{plan.smem_bytes} B dynamic shared memory a block", flush=True)
    err, kernel_ms, plain_ms = check_fit_kernel(
        fluid, fk, tfluid, fluid.init_state(1).params, atol,
        need_offdiag=name == "jpipe",
        atol64=ATOL64.get(name))
    check_small_input(tfluid, scene, Key, scene.eps_after_source(
        scene.bdry_eps), div_resolution=64 if scene.dim == 2 else 24)

    res = scene.vel_vis_resolution
    grid = uniform_grid(scene.scene_size, res, device="cuda")
    free, src = free_region(fluid, grid)

    def energy(u):
        return float(0.5 * torch.mean(torch.sum(u[free] ** 2, -1)))

    # ---- the path at full width
    fk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fluid.add_source(fluid.init_state(0))
    _sync()
    wall = time.perf_counter() - t0
    u = tfluid._velocity_grid(fluid, state.params, state.eps, 0, res, False)
    src_err = float(torch.sum((u - src)[free] ** 2)
                    / torch.sum(src[free] ** 2))
    print(f"{name} add_source: {wall:.2f} s, source-fit error "
          f"{src_err:.6e} (relative squared, {tuple(grid.shape[:-1])} grid, "
          f"{int(free.sum())} free points; bound {err_bound:g})", flush=True)
    if not src_err < err_bound:
        raise AssertionError(f"{name} source-fit error {src_err} >= "
                             f"{err_bound}")
    source = state
    state = state._replace(eps=scene.eps_after_source(state.eps))
    fluid.profile = True
    per_frame = []
    for s in range(n_steps):
        fluid.stage_times = {}
        _walk_report(0.0)
        before = fk.launches
        t0 = time.perf_counter()
        state = fluid.step(state)
        _sync()
        wall = time.perf_counter() - t0
        per_frame.append(fk.launches - before)
        stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
        print(f"{name} step {s + 1}: {wall:.2f} s, stages "
              f"{json.dumps(stages)}, fit-kernel launches {per_frame[-1]}, "
              f"P {float(state.P):.6e}; "
              f"{_walk_report(stages['wost_solve'])}", flush=True)
    u = tfluid._velocity_grid(fluid, state.params, state.eps,
                              state.timestep, res, False)
    ratio = energy(u) / energy(src)
    print(f"{name} after {n_steps} steps: kinetic energy "
          f"{float(fluid.kinetic_energy(state)):.6e}, 0.5 mean|u|^2 "
          f"{energy(u):.6e} = {ratio:.4f} x the source's (band {band})",
          flush=True)
    if fk.launches != 1 + 2 * n_steps or per_frame != [2] * n_steps:
        raise AssertionError(f"{name}: expected {1 + 2 * n_steps} fit-kernel"
                             f" launches (1 source + 2 a step), got "
                             f"{fk.launches} ({per_frame} in the steps)")
    if n_steps:
        _check_finite(state, fluid._last_projection)
        _, p, _, div = fluid._last_projection
        want = (grid_resolutions(scene.scene_size, fluid.div_resolution),
                (fluid.n_pressure,))
        if (tuple(div.shape), tuple(p.shape)) != want:
            raise AssertionError(f"{name} shapes: div {tuple(div.shape)}, "
                                 f"p {tuple(p.shape)}, expected {want}")
    if not band[0] <= ratio <= band[1]:
        raise AssertionError(f"{name} 0.5 mean|u|^2 after the steps is "
                             f"{ratio} x the source's")
    print(f"{name} peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if name in SOUP_PATHS:
        PATH_RUNS[name] = dict(projection=fluid._last_projection,
                               P=float(state.P), ratio=ratio,
                               walk_s=fluid.stage_times["wost_solve"])
    entry = _fit_entry(name, fluid, fk.launches,
                       per_frame[0] if per_frame else None, err, kernel_ms,
                       plain_ms)
    del fluid, state, grid, free, src, u
    torch.cuda.empty_cache()
    return entry, source


def _fresh_batch_on_card(tfluid, name, over, kw):
    """The fresh-batch fit (_adam_fit_single) on the card against the CPU:
    the source fit from the same Key(1) params on the same Key(5) batch
    keys (drawn on the CPU and moved), 25 iterations at lr 1e-3, ls_head
    0. Params at the fit kernel's tolerance of the family (rtol 2e-4 /
    atol 1e-3: tests/test_fitkernel.py's deep nets and PATHS' smoke
    family), the loss and the trace at its loss rtol 1e-2, iteration
    counts and trace lengths equal. Returns (max_abs_err, card ms/iter)."""
    import dataclasses
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.utils.keys import Key
    scene = dataclasses.replace(get_scene(name), lr=1e-3, **over)
    kw = dict(kw, fit_mode="xla", max_n_iters=25, ls_head=0)
    out = {}
    for dev in ("cuda", "cpu"):
        fluid = tfluid.NeuralFluid(scene, device=dev, **kw)
        state = fluid.init_state(1)
        tfluid._fit_source(fluid, state.params, Key(5), scene.bdry_eps, 0)
        _sync()
        t0 = time.perf_counter()
        params, st = tfluid._fit_source(fluid, state.params, Key(5),
                                        scene.bdry_eps, 0)
        _sync()
        out[dev] = (params, st, (time.perf_counter() - t0) * 1e3 / st.iters)
    (pg, sg, ms), (pc, sc, ms_cpu) = out["cuda"], out["cpu"]
    if (sg.iters, tuple(sg.trace.shape)) != (sc.iters, tuple(sc.trace.shape)):
        raise AssertionError(f"{name} fresh-batch fit: iterations "
                             f"{sg.iters} / {sc.iters}, traces "
                             f"{tuple(sg.trace.shape)} / "
                             f"{tuple(sc.trace.shape)}")
    err = 0.0
    for (a, b), (c, d) in zip(pg, pc):
        for u, v in ((a, c), (b, d)):
            torch.testing.assert_close(u.cpu(), v, rtol=2e-4, atol=1e-3)
            err = max(err, float((u.cpu() - v).abs().max()))
    torch.testing.assert_close(sg.loss.cpu(), sc.loss, rtol=1e-2, atol=0)
    torch.testing.assert_close(sg.trace.cpu(), sc.trace, rtol=1e-2, atol=0)
    print(f"{name} {scene.nonlinearity} fresh-batch fit, card vs CPU: "
          f"{sg.iters} iterations each, trace {tuple(sg.trace.shape)}, "
          f"max_abs_err {err:.3e} (atol 1e-3); {ms:.3f} ms/iter on the "
          f"card, {ms_cpu:.3f} on the CPU", flush=True)
    return err, ms


def cli_phase(tg_step1, tg_errors):
    """The command line (nmcfluid_torch.run.main, as `python -m
    nmcfluid_torch.run` calls it) on the card, at full width:
    1. taylorgreen --n_timesteps 1 --density --stage_times: its
       checkpoint after step 1 is the TG phase's params after step 1, bit
       for bit, and error_ours.txt rows 0 and 1 the TG phase's errors;
       then --ckpt 1 --until 2 --density resumes (a new key tree) to
       ckpt_step_t002.npz and error row 2 under the phase's 5e-3 bound.
       One fit-kernel launch a fit: 3, then 2.
    2. smoke --n_timesteps 1 --density on the 200^3 density grid: each
       density frame within [0, the initial density's max] (linear pulls
       cannot leave it; the weights sum to 1 to within float32 rounding,
       hence 8 ulps over the max), energy.txt one finite row, 3 launches.
    3. The fresh-batch fit on the card against the CPU at TG's shapes and
       at smoke's with tanh (_fresh_batch_on_card).
    4. taylorgreen --fit_mode xla --vis_frequency 50 --max_n_iters 200
       --adv_ref 1 --wost_resolution 256: four loss traces of 4 rows, two
       projections (one walk chunk each), no fit-kernel launch.
    5. curl2d of the TG net on a 64^2 grid, card against CPU, at the
       divergence grid's tolerance (rtol 1e-4 / atol 5e-5).
    Returns the fit-kernel launches of runs 1 and 2 by scene."""
    import tempfile
    from nmcfluid_torch import run as trun
    from nmcfluid_torch.ops.diff_ops import curl2d
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.sim.sampling import uniform_grid
    from nmcfluid_torch.transport.density import init_density
    from nmcfluid_torch.utils.checkpoint import load_ckpt

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = f"{tmp}/taylorgreen"

        def cli(argv, scene):
            fk.launches = 0
            t0 = time.perf_counter()
            trun.main(argv)
            _sync()
            n = fk.launches
            launches[scene] = launches.get(scene, 0) + n
            print(f"cli {' '.join(argv[:1] + argv[3:])}: "
                  f"{time.perf_counter() - t0:.2f} s, fit-kernel launches "
                  f"{n}", flush=True)
            return n

        # ---- 1. Taylor-Green, then a resume
        n = cli(["taylorgreen", "--out", tmp, "--n_timesteps", "1",
                 "--density", "--stage_times"], "taylorgreen")
        if n != 3:
            raise AssertionError(f"CLI taylorgreen: {n} fit-kernel launches,"
                                 f" expected 3")
        params, t = load_ckpt(f"{exp}/model", tg_step1, 1)
        same = all(torch.equal(a, b) for pa, pb in zip(params, tg_step1)
                   for a, b in zip(pa, pb))
        diff = max(float((a - b).abs().max()) for pa, pb in
                   zip(params, tg_step1) for a, b in zip(pa, pb))
        print(f"CLI checkpoint after step 1 vs the TG phase's params: "
              f"{'bit-identical' if same else 'differ'} (max |diff| "
              f"{diff:.3e})", flush=True)
        if not same or t != 1:
            raise AssertionError("the CLI's step-1 checkpoint is not the "
                                 "TG phase's params")
        rows = np.loadtxt(f"{exp}/error_ours.txt")
        print(f"CLI error_ours.txt {rows.tolist()}; TG phase "
              f"{tg_errors[:2]}", flush=True)
        if rows.shape != (2,) or rows.tolist() != tg_errors[:2]:
            raise AssertionError("error_ours.txt rows 0-1 are not the TG "
                                 "phase's errors")
        n = cli(["taylorgreen", "--out", tmp, "--ckpt", "1", "--until", "2",
                 "--density"], "taylorgreen")
        rows2 = np.loadtxt(f"{exp}/error_ours.txt")
        load_ckpt(f"{exp}/model", tg_step1, 2)
        if n != 2 or rows2.shape != (3,) or rows2[:2].tolist() != \
                rows.tolist() or not (np.isfinite(rows2[2])
                                      and rows2[2] < 5e-3):
            raise AssertionError(f"CLI resume: {n} launches, error rows "
                                 f"{rows2.tolist()}")
        print(f"CLI resume --ckpt 1 --until 2: error row 2 {rows2[2]:.6e} "
              f"(bound 5e-3)", flush=True)

        # ---- 2. smoke with the 200^3 density replay
        torch.cuda.reset_peak_memory_stats()
        n = cli(["smoke", "--out", tmp, "--n_timesteps", "1", "--density"],
                "smoke")
        peak = torch.cuda.max_memory_allocated() / 2**30
        if n != 3:
            raise AssertionError(f"CLI smoke: {n} fit-kernel launches")
        d0 = init_density(get_scene("smoke"), 200, device="cuda")
        top = float(d0.max()) * (1 + 8 * 2.0 ** -24)
        for t in (0, 1):
            with np.load(f"{tmp}/smoke/density/density_t{t:03d}.npz") as z:
                d, vel = z["density"], z["vel"]
            if d.shape != (200,) * 3 or vel.shape != (200,) * 3 + (3,) or \
                    not (d.min() >= 0.0 and d.max() <= top) or \
                    not np.isfinite(vel).all():
                raise AssertionError(f"smoke density frame {t}: shape "
                                     f"{d.shape}, range [{d.min()}, "
                                     f"{d.max()}] (max {top})")
            print(f"smoke density frame {t}: [{d.min():.6e}, {d.max():.6e}]"
                  f" within [0, {float(d0.max()):.6e}]", flush=True)
        energy = np.loadtxt(f"{tmp}/smoke/energy.txt", ndmin=1)
        if energy.shape != (1,) or not np.isfinite(energy).all():
            raise AssertionError(f"smoke energy.txt {energy}")
        print(f"CLI smoke: energy {energy[0]:.6e}, peak device memory "
              f"{peak:.2f} GiB", flush=True)
        del d0

        # ---- 3. the fresh-batch fit, card against CPU
        for name, over, kw in (
                ("taylorgreen", {}, dict(grad_clip=0.1, param_ema=0.9,
                                         loss_trace=5)),
                ("smoke", dict(nonlinearity="tanh"),
                 dict(grad_clip=0.1, param_ema=0.9, loss_trace=5))):
            _fresh_batch_on_card(tfluid, name, over, kw)

        # ---- 4. the fresh-batch path through the CLI
        solves = []
        solve = tfluid._pressure_solve

        def counted(*a):
            solves.append(1)
            return solve(*a)
        tfluid._pressure_solve = counted
        try:
            n = cli(["taylorgreen", "--out", tmp, "--exp_name", "xla",
                     "--fit_mode", "xla", "--vis_frequency", "50",
                     "--max_n_iters", "200", "--adv_ref", "1",
                     "--wost_resolution", "256", "--n_timesteps", "1",
                     "--stage_times"], "xla")
        finally:
            tfluid._pressure_solve = solve
        traces = sorted(f for f in os.listdir(f"{tmp}/xla/txt")
                        if f.startswith("loss_"))
        shapes = {np.loadtxt(f"{tmp}/xla/txt/{f}").shape for f in traces}
        if n != 0 or len(traces) != 4 or shapes != {(4,)} or \
                len(solves) != 2:
            raise AssertionError(f"CLI fresh-batch run: {n} launches, "
                                 f"traces {traces} {shapes}, {len(solves)}"
                                 f" walk chunks")
        print(f"CLI fresh-batch adv_ref run: {traces}, 2 projections of one "
              f"walk chunk, no fit-kernel launch", flush=True)

    # ---- 5. curl2d on the card against the CPU
    scene = get_scene("taylorgreen")
    fl = {dev: tfluid.NeuralFluid(scene, device=dev) for dev in ("cuda",
                                                                 "cpu")}
    w = {}
    for dev, f in fl.items():
        params = [(W.to(dev), b.to(dev)) for W, b in tg_step1]
        grid = uniform_grid(scene.scene_size, 64, device=dev)
        w[dev] = curl2d(lambda x: f.velocity(params, x, eps=scene.bdry_eps,
                                             t=1), grid)
    torch.testing.assert_close(w["cuda"].cpu(), w["cpu"], rtol=1e-4,
                               atol=5e-5)
    print(f"curl2d of the TG net, 64^2 grid: card vs CPU max |diff| "
          f"{float((w['cuda'].cpu() - w['cpu']).abs().max()):.3e}; the CLI "
          f"phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# The deterministic projections, each path at its projections: bem in 2D
# (TG, karman, jpipe), spectral on the box and where the obstacle is one
# circle, cylinder or sphere (TG, karman, the four 3D scenes).
PROJECTIONS = (("taylorgreen", "bem"), ("taylorgreen", "spectral"),
               ("karman", "bem"), ("karman", "spectral"), ("jpipe", "bem"),
               ("smoke", "spectral"), ("smoke_obs", "spectral"),
               ("karman3d", "spectral"), ("vortex_collide", "spectral"))

# A projection on the card against the same function on the CPU: the
# two devices run the same float32 formulas through other FFTs and other
# reduction orders (cuFFT against pocketfft, the BEM's (B, B) matvec and
# its splat's sums over B), so p and grad p are held to 1e-4 of their
# largest magnitude on the CPU. The CPU parity tests hold the two
# packages at 1e-5 (tests/test_torch_spectral.py, test_torch_bem.py).
PROJECTION_TOL = 1e-4


def check_small_projection(tfluid, scene, projection, Key):
    """The projection of one divergence grid (a numpy seed's) at the same
    pressure cloud on the card and on the CPU, small: a 64-cell 2D grid
    (24^3 in 3D) and 32^2 points. Returns max|card - CPU| / max|CPU| of
    (p, grad p)."""
    kw = dict(sample_resolution=16, wost_resolution=32, max_n_iters=50,
              fit_pool=8, div_resolution=64 if scene.dim == 2 else 24,
              n_walks=48, projection=projection)
    out = {}
    for dev in ("cuda", "cpu"):
        fluid = tfluid.NeuralFluid(scene, device=dev, **kw)
        res = tfluid.sampling.grid_resolutions(scene.scene_size,
                                               fluid.div_resolution)
        div = torch.from_numpy(np.random.RandomState(11).randn(*res)
                               .astype(np.float32)).to(dev)
        if projection == "bem":
            bp = tfluid.BemProjector(scene, fluid.div_resolution,
                                     device=dev)
            out[dev] = tfluid._pressure_solve_bem(fluid, bp, div, Key(11))
        elif projection == "bvc":
            bp = tfluid.BvcProjector(scene, fluid.div_resolution,
                                     fluid._wost_scene, fluid.walk_settings,
                                     device=dev)
            out[dev] = tfluid._pressure_solve_bvc(fluid, bp, div, Key(11))
        else:
            out[dev] = tfluid._pressure_solve_spectral(fluid, div, Key(11))
    (pts_g, val_g, p_g, g_g), (pts_c, val_c, p_c, g_c) = (
        out["cuda"], out["cpu"])
    torch.testing.assert_close(pts_g.cpu(), pts_c, rtol=2e-7, atol=2.4e-7)
    if not torch.equal(val_g.cpu(), val_c):
        raise AssertionError("valid flags of the pressure cloud differ")
    errs = []
    for what, a, b in (("p", p_g, p_c), ("grad p", g_g, g_c)):
        rel = float((a.cpu() - b).abs().max() / b.abs().max())
        if not rel <= PROJECTION_TOL:
            raise AssertionError(f"{scene.name} {projection} {what}: card "
                                 f"vs CPU {rel:.3e} of the magnitude > "
                                 f"{PROJECTION_TOL}")
        errs.append(rel)
    print(f"{scene.name} {projection} small input: p and grad p on the "
          f"card against the CPU at {errs[0]:.3e} and {errs[1]:.3e} of "
          f"their magnitude (tolerance {PROJECTION_TOL:g})", flush=True)
    return errs


def bem_split(fluid, repeats=3):
    """The BEM solve of the step's own divergence grid at its own cloud,
    split by part with CUDA events (ms, the mean of `repeats`): the FFT
    volume potentials, the boundary values (the (B, B) matvec with its
    lookups) and the splat over the cloud."""
    from nmcfluid_torch.sim import bem
    bp = fluid._bem
    pts, _, _, div = fluid._last_projection
    ss = bp.scene.scene_size
    parts = {"volume_potentials": lambda: bem._volume_potentials(bp, div)}
    V, Gx, Gy = parts["volume_potentials"]()
    parts["boundary_values"] = lambda: bp.A_inv @ bem._vertex_bilerp(
        V, ss, bp.cache_pts)
    u_gamma = parts["boundary_values"]()
    parts["splat"] = lambda: bem._splat(bp, u_gamma, V, Gx, Gy, pts)
    out = {}
    for k, fn in parts.items():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        fn()
        ev[0].record()
        for _ in range(repeats):
            fn()
        ev[1].record()
        ev[1].synchronize()
        out[k] = ev[0].elapsed_time(ev[1]) / repeats
    return out


def projection_phase(name, projection, source, entry, band,
                     walk_settings=None):
    """One step of a path under a deterministic projection, from the
    path's own add_source state (the source fit does not depend on the
    projection), at full width: the small input on the card against the
    CPU, one fit-kernel launch a fit, the stage times (the BEM's host
    precompute apart from its solve), peak memory, a finite P, and the
    path's band: the TG velocity error under 5e-3 in Taylor-Green, else
    0.5 mean|u|^2 on the free region within `band` x the source's.
    Under bvc the cache walk's generations and steps are printed, and
    `walk_settings` (None: the scene's) sets its executor. Returns the fit
    kernel's report entry on this path (the kernel's measurements at the
    path's shapes, this path's launches)."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.sim.sampling import uniform_grid
    from nmcfluid_torch.transport.density import (raw_velocity_grid,
                                                  tg_velocity_error)
    from nmcfluid_torch.utils.keys import Key

    scene = get_scene(name)
    errs = check_small_projection(tfluid, scene, projection, Key)
    fluid = tfluid.NeuralFluid(scene, device="cuda", projection=projection,
                               walk_settings=walk_settings)
    state = source._replace(eps=scene.eps_after_source(source.eps))
    fluid.profile, fluid.stage_times = True, {}
    fk.launches = 0
    _walk_report(0.0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fluid.step(state)
    _sync()
    wall = time.perf_counter() - t0
    launches = fk.launches
    stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
    if launches != 2:
        raise AssertionError(f"{name} {projection}: {launches} fit-kernel "
                             f"launches in the step, expected 2")
    _check_finite(state, fluid._last_projection)
    if name == "taylorgreen":
        err_tg = tg_velocity_error(raw_velocity_grid(fluid, state.params,
                                                     1000))
        reading, ok = f"TG velocity error {err_tg:.6e}", err_tg < 5e-3
    else:
        grid = uniform_grid(scene.scene_size, scene.vel_vis_resolution,
                            device="cuda")
        free, src = free_region(fluid, grid)
        u = tfluid._velocity_grid(fluid, state.params, state.eps,
                                  state.timestep, scene.vel_vis_resolution,
                                  False)
        ratio = (float(torch.mean(torch.sum(u[free] ** 2, -1)))
                 / float(torch.mean(torch.sum(src[free] ** 2, -1))))
        reading = (f"0.5 mean|u|^2 {ratio:.4f} x the source's (band "
                   f"{band})")
        ok = band[0] <= ratio <= band[1]
    walk = (f"; cache {_walk_report(stages['bvc_walk'], 'bvc_walk')} (B"
            f" = {fluid._bvc.n_boundary} cache points x "
            f"{fluid.walk_settings.n_walks} walks, "
            f"{fluid.walk_settings.gen_group_pairs} pairs a generation)"
            if projection == "bvc" else "")
    print(f"{name} {projection} step: {wall:.2f} s, stages "
          f"{json.dumps(stages)}, fit-kernel launches {launches}, P "
          f"{float(state.P):.6e}, {reading}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{walk}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} {projection}: {reading}")
    if projection == "bem":
        split = bem_split(fluid)
        print(f"{name} bem solve by part (CUDA events, ms): "
              f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
              f"B = {fluid._bem.n_boundary}, E = {fluid.n_pressure}, "
              f"{fluid._bem.eval_chunk}-point chunks", flush=True)
    out = dict(entry, path=f"{name} {projection}", launches=launches,
               launches_per_frame=launches, projection_err=errs)
    del fluid, state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- walks

# the screened mixed-boundary problem of tests/test_dirichlet.py and the
# double-sided barrier of tests/test_doublesided.py (box side 2)
WALK_L, WALK_SIG_D = 2.0, 5.0
BAR_M, BAR_SIG, BAR_CL, BAR_CR = 0.8, 10.0, 1.0, 2.0


def _mixed_scenes(device):
    """(mixed, barrier, p* of each, grad p* of each) on `device`."""
    import math
    from nmcfluid_torch.geometry.soup2d import build_segments, polyline_chain
    from nmcfluid_torch.wost.solver import WostScene
    L, kx = WALK_L, math.pi / WALK_L
    kl, kr = math.pi / BAR_M, math.pi / (L - BAR_M)

    def soup(chains, **kw):
        return build_segments([polyline_chain(c) for c in chains],
                              **kw).to(device)

    def p_mixed(x):
        return torch.cos(kx * x[..., 0]) * torch.cos(kx * x[..., 1])

    def g_mixed(x):
        return torch.stack([-kx * torch.sin(kx * x[..., 0])
                            * torch.cos(kx * x[..., 1]),
                            -kx * torch.cos(kx * x[..., 0])
                            * torch.sin(kx * x[..., 1])], -1)

    def p_bar(x):
        xx = x[..., 0]
        return torch.where(xx < BAR_M, BAR_CL * torch.cos(kl * xx),
                           BAR_CR * torch.cos(kr * (L - xx)))

    def g_bar(x):
        xx = x[..., 0]
        gx = torch.where(xx < BAR_M, -kl * BAR_CL * torch.sin(kl * xx),
                         kr * BAR_CR * torch.sin(kr * (L - xx)))
        return torch.stack([gx, torch.zeros_like(gx)], -1)

    def src_bar(x):
        xx = x[..., 0]
        return torch.where(
            xx < BAR_M, (BAR_SIG + kl ** 2) * BAR_CL * torch.cos(kl * xx),
            (BAR_SIG + kr ** 2) * BAR_CR * torch.cos(kr * (L - xx)))

    mixed = WostScene(
        dim=2, neumann=soup([[(0.0, L), (0.0, 0.0)], [(L, 0.0), (L, L)]]),
        source_fn=lambda x: (WALK_SIG_D + 2 * kx ** 2) * p_mixed(x),
        absorption=WALK_SIG_D,
        dirichlet=soup([[(0.0, 0.0), (L, 0.0)], [(L, L), (0.0, L)]]),
        dirichlet_fn=p_mixed)
    barrier = WostScene(
        dim=2, neumann=soup([[(0.0, 0.0), (L, 0.0)], [(L, L), (0.0, L)],
                             [(BAR_M, 0.0), (BAR_M, L)]], double_sided=True),
        source_fn=src_bar, absorption=BAR_SIG,
        dirichlet=soup([[(0.0, L), (0.0, 0.0)], [(L, 0.0), (L, L)]]),
        dirichlet_fn=p_bar)
    return {"mixed": (mixed, p_mixed, g_mixed),
            "barrier": (barrier, p_bar, g_bar)}


# the JAX tests' points and atol for each problem: the solution walk's
# points and atol, the gradient executors' points and (p, grad p) atol
# (their walks: MIXED_WALKS)
MIXED_CASES = {
    "mixed": ([[1.0, 0.35], [0.5, 0.7], [1.5, 1.65], [0.3, 1.2]], 0.05,
              [[1.0, 0.35], [0.5, 0.7], [1.5, 1.65], [0.3, 1.2]], 0.06,
              0.15),
    "barrier": ([[0.3, 1.0], [0.55, 0.5], [1.1, 1.0], [1.6, 1.4]], 0.08,
                [[0.4, 1.0], [1.3, 0.9]], 0.08, 0.2),
}
# walks of (the solution, the gradients) for each problem: the JAX tests'
# 3000 unless a key of keys 0-11 read over 80% of an atol there; these are
# tests/test_torch_walk_family.py's problems, keys and walks, whose readings
# the card's equal (port_key_audit.py; the barrier's gradient has a heavy
# tail: 102% of its atol at 3000 walks)
MIXED_WALKS = {"mixed": (3000, 10000), "barrier": (10000, 10000)}


def _mixed_boundary_checks(Key):
    """(b): each problem on the card with estimate_solution and with the
    gen and pool gradients (MIXED_WALKS; 2048 pairs a generation and 4096
    pool slots, which only reorder the work), held to
    the manufactured solution at the JAX tests' atol; then a small input
    (16 points, 64 walks) on the card against the CPU, nine points in ten
    at the gen tolerance and the rest within the walk's noise (the walls
    are segment soups, _walk_close). Returns seconds by check."""
    import dataclasses
    from nmcfluid_torch.wost.solver import (WalkSettings, estimate_solution,
                                            estimate_solution_and_gradient)
    secs = {}
    scenes = {dev: _mixed_scenes(dev) for dev in ("cuda", "cpu")}
    for name, (pts, atol_s, pts_g, atol_p, atol_g) in MIXED_CASES.items():
        scene, p_star, g_star = scenes["cuda"][name]
        base = WalkSettings(walk_step_cap=256, ignore_dirichlet=False,
                            solve_double_sided=name == "barrier",
                            gen_group_pairs=2048, pool_slots=4096,
                            gen_step_cap=256, pool_step_cap=256)
        walks_s, walks_g = MIXED_WALKS[name]
        x = torch.tensor(pts, device="cuda")
        t0 = time.perf_counter()
        p, n, _ = estimate_solution(scene, base, x, Key(0), walks_s)
        _sync()
        secs[f"{name} solution"] = time.perf_counter() - t0
        torch.testing.assert_close(p, p_star(x), rtol=0, atol=atol_s)
        if not bool((n > 2 * walks_s // 3).all()):
            raise AssertionError(f"{name}: valid walks {n.tolist()}")
        x = torch.tensor(pts_g, device="cuda")
        for algo in ("gen", "pool"):
            s = dataclasses.replace(base, algo=algo)
            t0 = time.perf_counter()
            p, g, n = estimate_solution_and_gradient(scene, s, x, Key(2),
                                                     walks_g)
            _sync()
            secs[f"{name} {algo}"] = time.perf_counter() - t0
            torch.testing.assert_close(p, p_star(x), rtol=0, atol=atol_p)
            torch.testing.assert_close(g, g_star(x), rtol=0, atol=atol_g)
        # the small input, card against CPU
        rng = np.random.default_rng(5)
        xs = torch.from_numpy(rng.uniform(0.1, 1.9, (16, 2)).astype(
            np.float32))
        if name == "barrier":
            xs[:, 0] = torch.where((xs[:, 0] - BAR_M).abs() < 0.05,
                                   xs[:, 0] + 0.1, xs[:, 0])
        out = {}
        for dev in ("cuda", "cpu"):
            sc = scenes[dev][name][0]
            out[dev] = [
                estimate_solution(sc, base, xs.to(dev), Key(7), 64)[0],
                *estimate_solution_and_gradient(
                    sc, dataclasses.replace(base, algo="pool"), xs.to(dev),
                    Key(7), 64)[:2]]
        spreads = [
            estimate_solution(scenes["cpu"][name][0], base, xs, Key(8),
                              64)[0],
            *estimate_solution_and_gradient(
                scenes["cpu"][name][0], dataclasses.replace(base,
                                                            algo="pool"),
                xs, Key(8), 64)[:2]]
        for what, a, b, c, rtol, atol in zip(
                ("solution", "pool p", "pool grad p"), out["cuda"],
                out["cpu"], spreads, (2e-4, 2e-4, 2e-3), (2e-5, 2e-5, 2e-4)):
            spread = float((b - c).pow(2).mean().sqrt()) / 2 ** 0.5
            _walk_close(f"{name} {what}", a.cpu(), b, spread, rtol, atol,
                        0.9)
    print("mixed boundaries on the card: the screened mixed problem and the "
          "double-sided barrier at the JAX tests' atol under "
          "estimate_solution, gen and pool; the small input on the card "
          "against the CPU; seconds "
          + json.dumps({k: round(v, 3) for k, v in secs.items()}),
          flush=True)
    return secs


def _image_scene_check(Key):
    """(c): tests/test_images_scene.py's mixed problem posed from PFM
    images written to a temporary directory, built with
    scene_from_images on the card and walked by estimate_solution (2000
    walks), held to p* at the JAX test's atol 0.07."""
    import tempfile
    from nmcfluid_torch.scenes.images import scene_from_images
    from nmcfluid_torch.utils.pfm import write_pfm
    from nmcfluid_torch.wost.solver import WalkSettings, estimate_solution
    L, sig, R = 2.0, 5.0, 256
    kx = np.pi / L
    yy, xx = np.meshgrid((np.arange(R) + 0.5) / R * L,
                         (np.arange(R) + 0.5) / R * L, indexing="ij")
    p_img = (np.cos(kx * xx) * np.cos(kx * yy)).astype(np.float32)
    isn = np.zeros((R, R), np.float32)
    isn[R // 8: -R // 8, :] = 1.0
    with tempfile.TemporaryDirectory() as d:
        obj = os.path.join(d, "box.obj")
        with open(obj, "w") as f:
            f.write("".join(f"v {x} {y}\n" for x, y in
                            [(0, 0), (L, 0), (L, L), (0, L)]))
            f.write("".join(f"l {i + 1} {(i + 1) % 4 + 1}\n"
                            for i in range(4)))
        paths = {}
        for name, img in (("source", (sig + 2 * kx ** 2) * p_img),
                          ("dirichlet_value", p_img), ("is_neumann", isn)):
            paths[name] = os.path.join(d, f"{name}.pfm")
            write_pfm(paths[name], img.astype(np.float32))
        scene, meta = scene_from_images(obj, absorption=sig, device="cuda",
                                        **paths)
    x = torch.tensor([[1.0, 0.4], [0.6, 1.5]], device="cuda")
    t0 = time.perf_counter()
    p, n, _ = estimate_solution(
        scene, WalkSettings(walk_step_cap=128, ignore_dirichlet=False), x,
        Key(0), 2000)
    _sync()
    dt = time.perf_counter() - t0
    want = torch.cos(kx * x[:, 0]) * torch.cos(kx * x[:, 1])
    torch.testing.assert_close(p, want, rtol=0, atol=0.07)
    if not bool((n > 1200).all()):
        raise AssertionError(f"image scene: valid walks {n.tolist()}")
    print(f"image-driven scene: {int(meta['is_neumann_seg'].sum())} Neumann "
          f"and {int((~meta['is_neumann_seg']).sum())} Dirichlet segments "
          f"from PFMs, p {[round(v, 4) for v in p.tolist()]} against "
          f"{[round(v, 4) for v in want.tolist()]} (atol 0.07), {dt:.3f} s",
          flush=True)
    return dt


def _pool_against_gen(tg_source, Key):
    """(a): one 65,536-point Taylor-Green chunk at 500 walks, the
    divergence grid of TG's add_source state as the source, on the card:
    pool against gen on the same streams (cv_warmup_pairs 16, a multiple
    of gen_group_pairs 4): equal valid counts, p and grad p at
    tests/test_gen.py's tolerances. Returns (gen s, pool s, pool trips,
    pool steps)."""
    import dataclasses
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.wost import gen, pool
    from nmcfluid_torch.wost.solver import estimate_solution_and_gradient
    fluid = tfluid.NeuralFluid(get_scene("taylorgreen"), device="cuda")
    div = tfluid._divergence_grid(fluid, tg_source.params, tg_source.eps, 0)
    pts, _ = tfluid._sample_pressure_cloud(fluid, Key(21))
    ws = fluid.walk_settings
    if ws.cv_warmup_pairs % ws.gen_group_pairs:
        raise AssertionError("the warmup is not a multiple of the group")
    out, secs = {}, {}
    gen.counts.update(dict.fromkeys(gen.counts, 0))
    pool.counts.update(dict.fromkeys(pool.counts, 0))
    for algo in ("gen", "pool"):
        _sync()
        t0 = time.perf_counter()
        out[algo] = estimate_solution_and_gradient(
            fluid._wost_scene, dataclasses.replace(ws, algo=algo), pts,
            Key(22), source_args=(div,))
        _sync()
        secs[algo] = time.perf_counter() - t0
    (pg, gg, ng), (pp, gp, np_) = out["gen"], out["pool"]
    if not torch.equal(ng, np_):
        raise AssertionError(f"pool and gen valid counts differ at "
                             f"{int((ng != np_).sum())} points")
    torch.testing.assert_close(pp, pg, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(gp, gg, rtol=2e-3, atol=2e-4)
    c = dict(pool.counts)
    print(f"pool against gen at {pts.shape[0]} TG points x "
          f"{ws.n_walks} walks: equal valid counts (mean "
          f"{float(ng.float().mean()):.1f}), p max diff "
          f"{float((pp - pg).abs().max()):.3e}, grad p "
          f"{float((gp - gg).abs().max()):.3e}; gen {secs['gen']:.3f} s "
          f"({gen.counts['generations']} generations, "
          f"{gen.counts['steps']} steps), pool {secs['pool']:.3f} s "
          f"({c['trips']} trips, {c['steps']} steps, "
          f"{c['seconds']:.3f} s in the drain)", flush=True)
    del fluid, div, out
    torch.cuda.empty_cache()
    return secs["gen"], secs["pool"], c["trips"], c["steps"]


# Pairs a generation of karman's bvc cache walk. The gen executor runs
# its 250 pairs a point in generations of gen_group_pairs (4), each as
# long as its longest walk: karman's ~106 steps a generation at 9-11 ms
# of host time a step, whatever the points, so 63 generations of the
# 4,096 cache points (32,768 lanes each) took 56-58 s, as long as the
# wost step's 63 generations of a 65,536-point chunk. 64 pairs give a
# generation the wost chunk's 524,288 lanes. The walks are the same
# (each pair's streams are keyed by its index) and so is the cached
# solution, up to the order of the float sums (the control variates'
# warm-up, which the group rounds up, enters the gradient only, which the
# bvc cache does not keep; tests/test_torch_bvc.py).
BVC_GROUP_PAIRS = 64


def walks_phase(sources, entries):
    """The walk family on the card: (a) pool against gen, (b) the mixed
    boundaries, (c) an image-driven scene, (d) one Taylor-Green step under
    bvc at full width from TG's add_source state (one fit-kernel launch a
    fit, bvc_walk and bvc_splat apart, peak memory, the TG error under
    5e-3 as in the projections phase), then one karman step under bvc at
    full width from karman's add_source state (projection_phase: the
    shipped net, 128^2 batches, 10,000-iteration fits, 500 walks; one
    fit-kernel launch a fit, the stage times, the energy ratio within
    karman's band), each bvc solve first held card against CPU on a small
    input; karman's cache walk in generations of BVC_GROUP_PAIRS pairs.
    Returns the fit kernel's report entries on the two bvc paths."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.transport.density import (raw_velocity_grid,
                                                  tg_velocity_error)
    from nmcfluid_torch.utils.keys import Key

    t_phase = time.perf_counter()
    tg_source = sources["taylorgreen"]
    fk.launches = 0
    _pool_against_gen(tg_source, Key)
    _mixed_boundary_checks(Key)
    _image_scene_check(Key)
    if fk.launches:
        raise AssertionError("the walk checks launched the fit kernel")
    err_small = check_small_projection(tfluid, get_scene("taylorgreen"),
                                       "bvc", Key)
    # (d) TG under bvc at full width
    fluid = tfluid.NeuralFluid(get_scene("taylorgreen"), device="cuda",
                               projection="bvc")
    fluid.profile, fluid.stage_times = True, {}
    torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    state = fluid.step(tg_source)
    _sync()
    wall = time.perf_counter() - t0
    launches = fk.launches
    stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
    if launches != 2:
        raise AssertionError(f"taylorgreen bvc: {launches} fit-kernel "
                             f"launches in the step, expected 2")
    _check_finite(state, fluid._last_projection)
    err_tg = tg_velocity_error(raw_velocity_grid(fluid, state.params, 1000))
    print(f"taylorgreen bvc step: {wall:.2f} s, stages "
          f"{json.dumps(stages)}, fit-kernel launches {launches}, P "
          f"{float(state.P):.6e}, TG velocity error {err_tg:.6e}, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; B = {fluid._bvc.n_boundary} cache points x "
          f"{fluid.walk_settings.n_walks} walks, E = {fluid.n_pressure}",
          flush=True)
    if not err_tg < 5e-3:
        raise AssertionError(f"taylorgreen bvc: TG velocity error {err_tg}")
    entry = next(e for e in entries if e["path"] == "taylorgreen")
    out = [dict(entry, path="taylorgreen bvc", launches=launches,
                launches_per_frame=launches, projection_err=err_small)]
    del fluid, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    band = next(path[5] for path in PATHS if path[0] == "karman")
    out.append(projection_phase(
        "karman", "bvc", sources["karman"],
        next(e for e in entries if e["path"] == "karman"), band,
        walk_settings=get_scene("karman").walk_settings(
            gen_group_pairs=BVC_GROUP_PAIRS)))
    print(f"karman bvc: the small input and the full-width step added "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"walks phase done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# ------------------------------------------------------ soups and sources

# tests/test_geometry.py:119-138's reflex corner: the two walls of an
# L-shaped prism's inner corner
REFLEX_VERTS = [[0, 0, 0], [2, 0, 0], [2, 1, 0], [1, 1, 0], [1, 2, 0],
                [0, 2, 0], [0, 0, 1], [2, 0, 1], [2, 1, 1], [1, 1, 1],
                [1, 2, 1], [0, 2, 1]]
REFLEX_FACES = [[3, 4, 10], [3, 10, 9], [3, 9, 8], [3, 8, 2]]


def _query_checks():
    """(a): every query of geometry/queries3d.py on the card against the
    CPU, on the unit cube and the reflex soup, at 4096 random points,
    directions, caps and second points: distances, points, normals and
    radii at rtol 1e-6 / atol 1e-6, flags equal. Returns seconds."""
    from nmcfluid_torch.geometry import box_tris, build_triangles
    from nmcfluid_torch.geometry import queries3d as q
    t0 = time.perf_counter()
    soups = {"cube": build_triangles(*box_tris((0.0,) * 3, (1.0,) * 3)),
             "reflex": build_triangles(np.asarray(REFLEX_VERTS, float),
                                       np.asarray(REFLEX_FACES))}
    rng = np.random.default_rng(0)
    for name, soup in soups.items():
        lo, hi = soup.bmin.numpy() - 0.5, soup.bmax.numpy() + 0.5
        d = rng.normal(size=(4096, 3))
        args = [torch.from_numpy(a.astype(np.float32)) for a in (
            rng.uniform(lo, hi, (4096, 3)),
            d / np.linalg.norm(d, axis=1, keepdims=True),
            rng.uniform(0.05, 3.0, 4096), rng.uniform(lo, hi, (4096, 3)))]
        x, dn, cap, y = args
        out = {}
        for dev in ("cuda", "cpu"):
            sp = soup.to(dev)
            xd, dd, cd, yd = (a.to(dev) for a in args)
            out[dev] = (list(q.closest_point(sp, xd))
                        + list(q.ray_intersect(sp, xd, dd, cd))
                        + [q.has_line_of_sight(sp, xd, yd),
                           q.star_radius(sp, xd, 1e-3, cd),
                           q.dist_to_far_bbox_corner(sp, xd),
                           q.outside_bbox(sp, xd)])
        for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
            a = a.cpu()
            if a.dtype == torch.bool:
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} query {i}: "
                                         f"{int((a != b).sum())} flags differ")
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        hits = float(out["cpu"][4].float().mean())
        sil = float((out["cpu"][9] < cap).float().mean())
        print(f"3D queries on the {name} soup ({soup.va.shape[0]} triangle "
              f"slots, {soup.ea.shape[0]} silhouette-edge slots), card "
              f"against CPU at 4096 points: equal; {hits:.3f} of the rays "
              f"hit, {sil:.3f} of the star radii stop at a silhouette",
              flush=True)
    return time.perf_counter() - t0


# tests/test_mixed3d.py's problems in the box [0, 2]^3: the mixed
# screened problem (Neumann x/y walls, Dirichlet z walls, sigma 5) and the
# double-sided barrier plane x = 0.8 (sigma 10)
MIXED3D_CASES = {
    # solution points and atol, gradient points and (p, grad p) atol
    "mixed": ([[1.0, 1.0, 0.4], [0.5, 0.7, 1.6], [1.5, 1.4, 1.0]], 0.06,
              [[1.0, 1.0, 0.4], [0.5, 0.7, 1.6], [1.5, 1.4, 1.0]], 0.07,
              0.17),
    "barrier": ([[0.3, 1.0, 1.0], [0.55, 0.5, 1.3], [1.1, 1.0, 1.0],
                 [1.6, 1.4, 0.6]], 0.1, [[0.4, 1.0, 1.0], [1.3, 0.9, 1.1]],
                0.1, 0.3),
}
# the gradients' walks: tests/test_torch_mixed3d.py's GRADIENT_WALKS for
# the same problems and keys (port_key_audit.py, CHANGES.md)
MIXED3D_GRADIENT_WALKS = {"mixed": 4000, "barrier": 6000}


def _mixed3d_scenes(device):
    """{name: (scene, p*, grad p*)} of MIXED3D_CASES on `device`."""
    import math
    from nmcfluid_torch.geometry import box_tris, build_triangles
    from nmcfluid_torch.wost.solver import WostScene
    L, kx = WALK_L, math.pi / WALK_L
    kl, kr = math.pi / BAR_M, math.pi / (L - BAR_M)
    v, f = box_tris((0.0,) * 3, (L,) * 3)
    v = np.concatenate([v, [[BAR_M, 0.0, 0.0], [BAR_M, L, 0.0],
                            [BAR_M, L, L], [BAR_M, 0.0, L]]])
    walls = {2: f[0:4], 1: f[4:8], 0: f[8:12],
             "bar": np.asarray([[8, 9, 10], [8, 10, 11]])}

    def soup(*keys):
        return build_triangles(v, np.concatenate(
            [walls[k] for k in keys])).to(device)

    def p_mixed(x):
        return torch.cos(kx * x[..., 0]) * torch.cos(kx * x[..., 2])

    def g_mixed(x):
        return torch.stack([-kx * torch.sin(kx * x[..., 0])
                            * torch.cos(kx * x[..., 2]),
                            torch.zeros_like(x[..., 0]),
                            -kx * torch.cos(kx * x[..., 0])
                            * torch.sin(kx * x[..., 2])], -1)

    def p_bar(x):
        xx = x[..., 0]
        return torch.where(xx < BAR_M, BAR_CL * torch.cos(kl * xx),
                           BAR_CR * torch.cos(kr * (L - xx)))

    def g_bar(x):
        xx = x[..., 0]
        gx = torch.where(xx < BAR_M, -kl * BAR_CL * torch.sin(kl * xx),
                         kr * BAR_CR * torch.sin(kr * (L - xx)))
        return torch.stack([gx, torch.zeros_like(gx), torch.zeros_like(gx)],
                           -1)

    def src_bar(x):
        xx = x[..., 0]
        return torch.where(
            xx < BAR_M, (BAR_SIG + kl ** 2) * BAR_CL * torch.cos(kl * xx),
            (BAR_SIG + kr ** 2) * BAR_CR * torch.cos(kr * (L - xx)))

    mixed = WostScene(
        dim=3, neumann=soup(0, 1), absorption=WALK_SIG_D,
        source_fn=lambda x: (WALK_SIG_D + 2 * kx ** 2) * p_mixed(x),
        dirichlet=soup(2), dirichlet_fn=p_mixed)
    barrier = WostScene(
        dim=3, neumann=soup(1, 2, "bar"), source_fn=src_bar,
        absorption=BAR_SIG, dirichlet=soup(0), dirichlet_fn=p_bar)
    return {"mixed": (mixed, p_mixed, g_mixed),
            "barrier": (barrier, p_bar, g_bar)}


def _mixed3d_checks(Key):
    """(b): each 3D problem on the card under estimate_solution (3000
    walks) and the gen and pool gradients (MIXED3D_GRADIENT_WALKS; 1024
    pairs a generation, 4096 pool slots and 256-step caps, as the 2D checks),
    held to the manufactured solution at the JAX tests' atol. Returns
    seconds by check."""
    import dataclasses
    from nmcfluid_torch.wost.solver import (WalkSettings, estimate_solution,
                                            estimate_solution_and_gradient)
    secs = {}
    scenes = _mixed3d_scenes("cuda")
    for name, (pts, atol_s, pts_g, atol_p, atol_g) in MIXED3D_CASES.items():
        scene, p_star, g_star = scenes[name]
        base = WalkSettings(walk_step_cap=256, ignore_dirichlet=False,
                            solve_double_sided=name == "barrier",
                            gen_group_pairs=1024, pool_slots=4096,
                            gen_step_cap=256, pool_step_cap=256)
        x = torch.tensor(pts, device="cuda")
        t0 = time.perf_counter()
        p, n, _ = estimate_solution(scene, base, x, Key(0), 3000)
        _sync()
        secs[f"{name} solution"] = time.perf_counter() - t0
        torch.testing.assert_close(p, p_star(x), rtol=0, atol=atol_s)
        if not bool((n > 2000).all()):
            raise AssertionError(f"3D {name}: valid walks {n.tolist()}")
        x = torch.tensor(pts_g, device="cuda")
        walks = MIXED3D_GRADIENT_WALKS[name]
        for algo in ("gen", "pool"):
            t0 = time.perf_counter()
            p, g, n = estimate_solution_and_gradient(
                scene, dataclasses.replace(base, algo=algo), x, Key(2), walks)
            _sync()
            secs[f"{name} {algo}"] = time.perf_counter() - t0
            torch.testing.assert_close(p, p_star(x), rtol=0, atol=atol_p)
            torch.testing.assert_close(g, g_star(x), rtol=0, atol=atol_g)
            if not bool((n > 2 * walks // 3).all()):
                raise AssertionError(f"3D {name} {algo}: valid walks "
                                     f"{n.tolist()}")
    print("3D boundary data on triangle soups, on the card: the mixed "
          "problem and the double-sided barrier at the JAX tests' atol "
          "under estimate_solution, gen and pool; seconds "
          + json.dumps({k: round(v, 3) for k, v in secs.items()}),
          flush=True)
    return secs


def _soup_smoke_step(smoke_source, entry, Key):
    """(c): one full-width smoke step walked on the 12-triangle cube soup
    (specs._cube_boundary_soup) from smoke's add_source state. The
    advection fit and the divergence grid are the smoke path's own (the
    same state, keys and bit-identical fit kernel), so the walk's inputs
    are too, and its points the same: p and grad p held to the analytic
    cube's step nine points in ten at the gen tolerance and the rest
    within 4 x the walk's spread (a second key on 4096 points), P within
    4 standard errors of the pointwise differences, the energy ratio in
    smoke's band and within 5% of the analytic step's; one fit-kernel
    launch a fit. Returns (the fit kernel's entry, wall s, walk s)."""
    import dataclasses
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.scenes.specs import _cube_boundary_soup
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.sim.sampling import uniform_grid
    from nmcfluid_torch.wost.solver import estimate_solution_and_gradient
    box = PATH_RUNS["smoke"]
    scene = dataclasses.replace(get_scene("smoke"),
                                _boundary_builder=_cube_boundary_soup)
    fluid = tfluid.NeuralFluid(scene, device="cuda")
    if type(fluid.boundary).__name__ != "Tri3D":
        raise AssertionError("the soup path does not walk a Tri3D")
    fluid.profile, fluid.stage_times = True, {}
    _walk_report(0.0)
    fk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fluid.step(smoke_source)
    _sync()
    wall = time.perf_counter() - t0
    launches = fk.launches
    stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
    walk = _walk_report(stages["wost_solve"])
    if launches != 2:
        raise AssertionError(f"smoke soup: {launches} fit-kernel launches "
                             "in the step, expected 2")
    _check_finite(state, fluid._last_projection)
    pts, p, g, div = fluid._last_projection
    pts_b, p_b, g_b, div_b = box["projection"]
    if not (torch.equal(pts, pts_b) and torch.equal(div, div_b)):
        raise AssertionError("smoke soup: the walk's inputs are not the "
                             "smoke path's")
    sub = pts[:4096]
    p2, g2, _ = estimate_solution_and_gradient(
        fluid._wost_scene, fluid.walk_settings, sub, Key(77),
        source_args=(div,))
    # the step's masks: p near the boundary; grad p there and at the
    # points the step zeroed (outside the domain, invalid draws)
    p2, g2 = tfluid._mask_pressure(fluid, sub, torch.ones_like(
        sub[:, 0], dtype=torch.bool), p2, g2)
    g2 = torch.where((g[:4096] == 0).all(-1, keepdim=True), 0.0, g2)
    spread_p = float((p[:4096] - p2).pow(2).mean().sqrt()) / 2 ** 0.5
    spread_g = float((g[:4096] - g2).pow(2).mean().sqrt()) / 2 ** 0.5
    _walk_close("smoke soup p", p.cpu(), p_b.cpu(), spread_p, 2e-4, 2e-5,
                0.9)
    _walk_close("smoke soup grad p", g.cpu(), g_b.cpu(), spread_g, 2e-3,
                2e-4, 0.9)
    dp = p - p_b
    se = float(dp.pow(2).mean().sqrt()) / p.shape[0] ** 0.5
    dP = float(state.P) - box["P"]
    res = scene.vel_vis_resolution
    grid = uniform_grid(scene.scene_size, res, device="cuda")
    free, src = free_region(fluid, grid)
    u = tfluid._velocity_grid(fluid, state.params, state.eps,
                              state.timestep, res, False)
    ratio = (float(torch.mean(torch.sum(u[free] ** 2, -1)))
             / float(torch.mean(torch.sum(src[free] ** 2, -1))))
    same = float(((dp.abs() <= 2e-5 + 2e-4 * p_b.abs())).float().mean())
    print(f"smoke step on the cube soup: {wall:.2f} s, stages "
          f"{json.dumps(stages)}, fit-kernel launches {launches}; {walk}; "
          f"walk {stages['wost_solve']} s against the analytic cube's "
          f"{box['walk_s']:.3f} s; P "
          f"{float(state.P):.6e} against {box['P']:.6e} (difference "
          f"{dP:.3e}, 4 standard errors {4 * se:.3e}); {same:.4f} of the "
          f"points' p at the gen tolerance; 0.5 mean|u|^2 {ratio:.4f} x the "
          f"source's against {box['ratio']:.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not abs(dP) <= 4 * se + 1e-7:
        raise AssertionError(f"smoke soup: P differs by {dP}, 4 standard "
                             f"errors {4 * se}")
    if not (0.25 <= ratio <= 2.0 and abs(ratio - box["ratio"])
            <= 0.05 * box["ratio"]):
        raise AssertionError(f"smoke soup: energy ratio {ratio} against "
                             f"{box['ratio']}")
    out = dict(entry, path="smoke soup", launches=launches,
               launches_per_frame=launches)
    del fluid, state
    torch.cuda.empty_cache()
    return out, wall, stages["wost_solve"]


def _net_source_small(tg_source, Key):
    """(d), first: the net source (-div u of the network by forward mode,
    fluid._wost_scene_net.source_fn) at 4,096 Taylor-Green walk points on
    the card against the CPU from TG's add_source weights, at the
    divergence grid's tolerance (rtol 1e-4, atol 5e-5); then one small
    net-source WoSt chunk (256 points x 48 walks) on the card against the
    CPU on the same key, at the gen tolerance (the walks' streams are the
    same; the source's rounding alone differs). Returns the largest
    differences (source, p, grad p)."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.sim.sampling import fluid_points
    scene = get_scene("taylorgreen")
    kw = dict(sample_resolution=16, wost_resolution=16, div_resolution=64,
              n_walks=48, max_n_iters=50, fit_pool=8, wost_source="net")
    gpu = tfluid.NeuralFluid(scene, device="cuda", **kw)
    cpu = tfluid.NeuralFluid(scene, device="cpu", **kw)
    params = tg_source.params
    params_cpu = [(W.cpu(), b.cpu()) for W, b in params]
    eps, t = tg_source.eps, tg_source.timestep
    y, _ = fluid_points(Key(41), 4096, scene, device="cpu")
    src_c = cpu._wost_scene_net.source_fn(y, params_cpu, eps, t)
    src_g = gpu._wost_scene_net.source_fn(y.cuda(), params, eps, t)
    torch.testing.assert_close(src_g.cpu(), src_c, rtol=1e-4, atol=5e-5)
    _, _, p_g, g_g = tfluid._pressure_solve(
        gpu, (params, eps, t), Key(13), gpu._wost_scene_net)
    _, _, p_c, g_c = tfluid._pressure_solve(
        cpu, (params_cpu, eps, t), Key(13), cpu._wost_scene_net)
    _walk_close("net source p", p_g.cpu(), p_c, 0.0, 2e-4, 2e-5, 1.0)
    _walk_close("net source grad p", g_g.cpu(), g_c, 0.0, 2e-3, 2e-4, 1.0)
    diffs = [float((a.cpu() - b).abs().max())
             for a, b in ((src_g, src_c), (p_g, p_c), (g_g, g_c))]
    print(f"net source on the card against the CPU: -div u at "
          f"{y.shape[0]} TG points max |diff| {diffs[0]:.3e} (|-div u| up "
          f"to {float(src_c.abs().max()):.3e}; rtol 1e-4, atol 5e-5); a "
          f"{p_c.shape[0]}-point net-source chunk p {diffs[1]:.3e}, grad p "
          f"{diffs[2]:.3e} (gen tolerance)", flush=True)
    return diffs


def _net_source_step(tg_source, entry, tg_step_err):
    """(d): one full-width Taylor-Green step under wost_source="net" from
    TG's add_source state, its walk cut in depth to one 65,536-point
    chunk (256^2): one fit-kernel launch a fit, the stage times,
    the TG velocity error under 5e-3 (the projections phase's bound),
    printed beside the grid source's step from the same state. Returns
    (the fit kernel's entry, wall s, walk s)."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.transport.density import (raw_velocity_grid,
                                                  tg_velocity_error)
    fluid = tfluid.NeuralFluid(get_scene("taylorgreen"), device="cuda",
                               wost_source="net", wost_resolution=256)
    fluid.profile, fluid.stage_times = True, {}
    _walk_report(0.0)
    fk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fluid.step(tg_source)
    _sync()
    wall = time.perf_counter() - t0
    launches = fk.launches
    stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
    if launches != 2:
        raise AssertionError(f"taylorgreen net: {launches} fit-kernel "
                             "launches in the step, expected 2")
    _check_finite(state, fluid._last_projection)
    err_tg = tg_velocity_error(raw_velocity_grid(fluid, state.params, 1000))
    print(f"taylorgreen step under wost_source net: {wall:.2f} s, stages "
          f"{json.dumps(stages)}, fit-kernel launches {launches}, P "
          f"{float(state.P):.6e}, TG velocity error {err_tg:.6e} (the grid "
          f"source's step from the same state {tg_step_err:.6e}); "
          f"{_walk_report(stages['wost_solve'])}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not err_tg < 5e-3:
        raise AssertionError(f"taylorgreen net: TG velocity error {err_tg}")
    out = dict(entry, path="taylorgreen net", launches=launches,
               launches_per_frame=launches)
    del fluid, state
    torch.cuda.empty_cache()
    return out, wall, stages["wost_solve"]


# the mesh check's walks a point: the equality it checks does not depend
# on them, and a walk's generations (its host time) grow with them
MESH_WALKS = 100


def _mesh_check(tg_source, Key):
    """(e): the wost pressure solve of 65,536 Taylor-Green points (256^2,
    MESH_WALKS walks) meshless and over a ["cuda:0", "cuda:0"] points
    mesh, on the same key and divergence grid. The mesh walks whole
    chunks, at least one a device, so it halves the one 65,536-point
    chunk; the
    meshless fluid walks the same two 32,768-point chunks in turn, the
    mesh one a device in a host thread each (parallel/mesh.py): points,
    flags, p and grad p equal bit for bit. Returns (meshless s, mesh
    s)."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fluid as tfluid
    scene = get_scene("taylorgreen")
    fl0 = tfluid.NeuralFluid(scene, device="cuda", wost_resolution=256,
                             n_walks=MESH_WALKS)
    fl2 = tfluid.NeuralFluid(scene, device="cuda", wost_resolution=256,
                             n_walks=MESH_WALKS, mesh=["cuda:0"] * 2)
    if (fl2.n_pressure, fl2.wost_chunk) != (65536, 32768):
        raise AssertionError(f"mesh: {fl2.n_pressure} points in chunks of "
                             f"{fl2.wost_chunk}")
    fl0.wost_chunk = fl2.wost_chunk
    div = tfluid._divergence_grid(fl0, tg_source.params, tg_source.eps, 0)
    outs, secs = [], []
    for fl in (fl0, fl2):
        _sync()
        t0 = time.perf_counter()
        outs.append(tfluid._pressure_solve_wost(fl, (div,), Key(31),
                                                fl._wost_scene))
        _sync()
        secs.append(time.perf_counter() - t0)
    for a, b, what in zip(*outs, ("points", "flags", "p", "grad p")):
        if not torch.equal(a, b):
            raise AssertionError(f"mesh: {what} differ from the meshless "
                                 f"solve at {int((a != b).sum())} entries")
    print(f"points mesh [cuda:0, cuda:0] against the meshless solve, "
          f"{outs[0][0].shape[0]} TG points in two 32768-point chunks: "
          f"equal bit for bit; meshless {secs[0]:.3f} s, mesh (one chunk "
          f"a device) {secs[1]:.3f} s", flush=True)
    del fl0, fl2, div, outs
    torch.cuda.empty_cache()
    return secs


def soups_phase(sources, entries, tg_step_err):
    """The solver's last ported features on the card: (a) the 3D queries,
    (b) 3D boundary data, (c) smoke on the cube soup, (d) Taylor-Green
    under the net source, (e) the points mesh. Returns the fit kernel's
    report entries of (c) and (d)."""
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.utils.keys import Key
    t_phase = time.perf_counter()
    fk.launches = 0
    q_s = _query_checks()
    _mixed3d_checks(Key)
    if fk.launches:
        raise AssertionError("the 3D walk checks launched the fit kernel")
    smoke_entry = next(e for e in entries if e["path"] == "smoke")
    tg_entry = next(e for e in entries if e["path"] == "taylorgreen")
    soup, soup_s, soup_walk = _soup_smoke_step(sources["smoke"], smoke_entry,
                                               Key)
    _net_source_small(sources["taylorgreen"], Key)
    net, net_s, net_walk = _net_source_step(sources["taylorgreen"],
                                            tg_entry, tg_step_err)
    mesh_s = _mesh_check(sources["taylorgreen"], Key)
    print(f"soups and sources phase done in "
          f"{time.perf_counter() - t_phase:.1f} s (queries {q_s:.1f} s, "
          f"soup step {soup_s:.2f} s with walk {soup_walk:.2f} s, net step "
          f"{net_s:.2f} s with walk {net_walk:.2f} s, mesh "
          f"{mesh_s[0]:.2f} / {mesh_s[1]:.2f} s)", flush=True)
    return [soup, net]


# the baselines-and-tools phase's cuts in depth (widths as shipped)
INSR_ITERS = 100        # INSR's iterations a phase (shipped 20,000)
TRAIN_ITERS = 200       # PINN's and PI-DeepONet's (shipped 50,000)
BASELINE_GRID = 250     # the honest error's grid (shipped 1000)
BASELINE_TOL = 1e-4     # card against CPU, of the magnitude
ORACLE_BOUND = 1e-2     # the oracle floor's frame 1 (an untrained net: ~0.5)


def _cuda_ms(fn):
    """(fn(), its milliseconds by CUDA events)."""
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    out = fn()
    ev1.record()
    _sync()
    return out, ev0.elapsed_time(ev1)


class _TimedFits:
    """While open, every SegmentedAdam fit is timed by CUDA events and
    logged as (iterations, ms)."""

    def __init__(self):
        from nmcfluid_torch.baselines import common
        self.cls, self.fit, self.log = common.SegmentedAdam, None, []

    def __enter__(self):
        self.fit = fit = self.cls.fit

        def timed(fitter, *a, **kw):
            out, ms = _cuda_ms(lambda: fit(fitter, *a, **kw))
            self.log.append((out[1], ms))
            return out
        self.cls.fit = timed
        return self.log

    def __exit__(self, *exc):
        self.cls.fit = self.fit


def _baseline_losses(device, Key):
    """Each baseline's losses at 3 x 256 on 32^2 = 1,024 points on
    `device`: {name: (loss, params, ctx)}, the weights from keys 0 and 1."""
    from nmcfluid_torch.baselines import (INSRFluid, PIDeepONetFluid,
                                          PINNFluid)
    kw = dict(sample_resolution=32, device=device)
    insr, pinn, pideep = INSRFluid(**kw), PINNFluid(**kw), \
        PIDeepONetFluid(**kw)
    s0, s1 = insr.init(key=Key(0)), insr.init(key=Key(1))
    return {
        "insr source": (insr._source_loss, s0["vel"], ()),
        "insr advect": (insr._advect_loss, s0["vel"], (s1["vel"],)),
        "insr pressure": (insr._pressure_loss, s0["p"], (s1["vel"],)),
        "insr project": (insr._project_loss, s0["vel"],
                         (s1["vel"], s1["p"])),
        "pinn": (pinn.loss, pinn.init(key=Key(0)), ()),
        "pideeponet": (pideep.loss, pideep.init(key=Key(0)), ())}


def _baselines_card_vs_cpu(Key):
    """(a) Each loss and its gradient by the weights, card against CPU on
    the same weights and draws, within BASELINE_TOL of the CPU's
    magnitude (the loss's; the gradient's largest entry)."""
    from nmcfluid_torch.utils.checkpoint import tree_leaves, tree_unflatten
    card, cpu = _baseline_losses("cuda", Key), _baseline_losses("cpu", Key)
    for name in card:
        out = []
        for fn, params, ctx in (card[name], cpu[name]):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in tree_leaves(params)]
            loss = fn(tree_unflatten(params, leaves), Key(5).fold_in(0),
                      *ctx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            out.append((float(loss.detach()), torch.cat(
                [g.reshape(-1) for g in grads]).cpu()))
        (l_g, g_g), (l_c, g_c) = out
        err_l = abs(l_g - l_c) / abs(l_c)
        err_g = float((g_g - g_c).abs().max() / g_c.abs().max())
        print(f"baseline {name} loss card vs CPU: {l_g:.6e} / {l_c:.6e} "
              f"(rel {err_l:.2e}), gradient rel {err_g:.2e}", flush=True)
        if not (err_l <= BASELINE_TOL and err_g <= BASELINE_TOL):
            raise AssertionError(f"baseline {name}: card vs CPU loss "
                                 f"{err_l:.2e}, gradient {err_g:.2e}")


def _insr_full_width(Key):
    """(b) INSR's source fit and one step at 3 x 256 on 128^2 points,
    INSR_ITERS iterations a phase: each phase's ms an iteration, finite
    losses, the source loss falling."""
    from nmcfluid_torch.baselines import INSRFluid
    m = INSRFluid(max_n_iters=INSR_ITERS, device="cuda")
    st, key = m.init(key=Key(0)), Key(0)
    with torch.no_grad():
        l0 = float(m._source_loss(st["vel"], key.fold_in(0)))
    with _TimedFits() as log:
        st["vel"], i, loss = m.fit_source(st["vel"], key)
        st = m.step(st, key.fold_in(1))
    loss = float(loss)
    if not (np.isfinite(loss) and loss < 0.5 * l0):
        raise AssertionError(f"INSR source loss {l0} -> {loss}")
    for name, params in st.items():
        for t in params:
            if not bool(torch.isfinite(t[0]).all()):
                raise AssertionError(f"INSR {name} weights not finite")
    names = ("source", "advect", "pressure", "project")
    ms = {n: ms / it for n, (it, ms) in zip(names, log)}
    print(f"INSR at 3 x 256 on 128^2 points, {INSR_ITERS} iterations a "
          f"phase (shipped 20,000): source loss {l0:.4e} -> {loss:.4e}; "
          + ", ".join(f"{n} {ms[n]:.3f} ms/iter" for n in names), flush=True)
    return ms


def _trainers_full_width(Key, out_root):
    """(b) PINN and PI-DeepONet through baselines.run.main at TRAIN_ITERS
    iterations and the BASELINE_GRID grid, 50 frames: the files written,
    finite curves, ms an iteration."""
    from nmcfluid_torch.baselines import run as brun
    ms = {}
    for method in ("pinn", "pideeponet"):
        out = os.path.join(out_root, method)
        with _TimedFits() as log:
            brun.main([method, "--max_n_iters", str(TRAIN_ITERS), "--grid",
                       str(BASELINE_GRID), "--out", out])
        (it, t_ms), = log
        ms[method] = t_ms / it
        means = []
        for f in (f"error_{method}.txt", f"error_{method}_refpipe.txt"):
            curve = np.loadtxt(os.path.join(out, f))
            if curve.shape != (50,) or not np.all(np.isfinite(curve)):
                raise AssertionError(f"{method} {f}: {curve.shape}")
            means.append(curve.mean())
        print(f"{method} at 3 x 256 on 128^2 points, {it} iterations "
              f"(shipped 50,000), grid {BASELINE_GRID} (shipped 1000): "
              f"{ms[method]:.3f} ms/iter; mean error {means[0]:.4e}, "
              f"refpipe {means[1]:.4e}", flush=True)
    return ms


def _oracle_floor_frame(tg_entry, Key):
    """(c) One oracle-floor frame at Taylor-Green's shipped width: the
    add_source and the frame's two source fits, one fit-kernel launch
    each, counted; the frame's TG error finite and under ORACLE_BOUND.
    Returns the fit kernel's report entry on this path."""
    from nmcfluid_torch import tools_oracle_floor as tof
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim.fluid import NeuralFluid
    fluid = NeuralFluid(get_scene("taylorgreen"), device="cuda")
    fk.launches = 0
    state = fluid.add_source(fluid.init_state(key=Key(0)))
    (_, err), = tof.oracle_floor(fluid, state, 1)
    launches = fk.launches
    if launches != 3 or not (np.isfinite(err) and err < ORACLE_BOUND):
        raise AssertionError(f"oracle floor: {launches} fit-kernel "
                             f"launches, error {err}")
    print(f"oracle floor frame 1: TG error {err:.4e}, {launches} fit-kernel "
          f"launches (add_source and two fits)", flush=True)
    entry = dict(tg_entry)
    entry.update(path="oracle_floor", launches=launches,
                 launches_per_frame=2)
    return entry


def baselines_phase(tg_entry):
    """The comparison baselines and the analysis tools on the card: (a)
    card against CPU, (b) full width cut in depth, (c) the oracle floor.
    Returns the fit kernel's report entry on the oracle-floor path."""
    import tempfile
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.utils.keys import Key
    t_phase = time.perf_counter()
    fk.launches = 0
    _baselines_card_vs_cpu(Key)
    with tempfile.TemporaryDirectory() as tmp:
        insr_ms = _insr_full_width(Key)
        train_ms = _trainers_full_width(Key, tmp)
    if fk.launches:
        raise AssertionError("the baselines launched the fit kernel")
    entry = _oracle_floor_frame(tg_entry, Key)
    print(f"baselines and tools phase done in "
          f"{time.perf_counter() - t_phase:.1f} s (ms/iter: "
          + ", ".join(f"{k} {v:.3f}" for k, v in {
              **{f"insr {k}": v for k, v in insr_ms.items()},
              **train_ms}.items()) + ")", flush=True)
    return entry


# ----------------------------------------------------------- executors

# the lockstep chunk's side (256^2 = 65,536 points, one pressure chunk)
# and its bound: its mean |dp| and |d grad p| against the pool within
# EXEC_RATIO x the pool's against itself on another key
EXEC_SIDE = 256
EXEC_RATIO = 1.5
ENSEMBLE_ATOL = 1e-5    # the fit kernel's check


def _lockstep_chunk(tg_source, Key):
    """(a) One Taylor-Green pressure solve under walk_algo "lockstep"
    (fastrand) at 500 walks on one 65,536-point chunk through the fluid's
    _pressure_solve, the divergence grid of TG's add_source state as the
    source; then the pool on the same points and walk key, and on another
    walk key: independent realizations of one estimator, so the lockstep
    chunk's mean |dp| and |d grad p| against the pool stay within
    EXEC_RATIO x the pool's against itself. Returns the seconds of each."""
    import dataclasses
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.wost import pool, solver
    scene = get_scene("taylorgreen")
    fluid = tfluid.NeuralFluid(scene, device="cuda",
                               wost_resolution=EXEC_SIDE)
    ws = fluid.walk_settings
    lock = tfluid.NeuralFluid(scene, device="cuda", wost_resolution=EXEC_SIDE,
                              walk_settings=dataclasses.replace(
                                  ws, algo="lockstep"))
    div = tfluid._divergence_grid(fluid, tg_source.params, tg_source.eps, 0)
    key = Key(31)
    solver.counts.update(dict.fromkeys(solver.counts, 0))
    secs = {}
    _sync()
    t0 = time.perf_counter()
    pts, valid, p_l, g_l = tfluid._pressure_solve(lock, (div,), key)
    _sync()
    secs["lockstep"] = time.perf_counter() - t0
    passes, steps = solver.counts["passes"], solver.counts["steps"]
    out = []
    for k in (key.split(2)[1], Key(32)):
        _sync()
        t0 = time.perf_counter()
        p, g, _ = solver.estimate_solution_and_gradient(
            fluid._wost_scene, dataclasses.replace(ws, algo="pool"), pts, k,
            source_args=(div,))
        _sync()
        secs.setdefault("pool", []).append(time.perf_counter() - t0)
        out.append(tfluid._mask_pressure(fluid, pts, valid, p, g))
    (p_a, g_a), (p_b, g_b) = out
    means = {"lockstep-pool p": float((p_l - p_a).abs().mean()),
             "lockstep-pool grad p": float((g_l - g_a).abs().mean()),
             "pool-pool p": float((p_a - p_b).abs().mean()),
             "pool-pool grad p": float((g_a - g_b).abs().mean())}
    print(f"lockstep chunk: {pts.shape[0]} TG points x {ws.n_walks} walks "
          f"in {secs['lockstep']:.3f} s ({passes} passes, {steps} walk "
          f"steps); pool {secs['pool'][0]:.3f} / {secs['pool'][1]:.3f} s; "
          f"mean differences " + json.dumps(
              {k: float(f"{v:.6e}") for k, v in means.items()}), flush=True)
    for t in (p_l, g_l):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("lockstep chunk: not finite")
    for what in ("p", "grad p"):
        if not (means[f"lockstep-pool {what}"]
                <= EXEC_RATIO * means[f"pool-pool {what}"]):
            raise AssertionError(f"lockstep chunk: mean |d {what}| "
                                 f"{means}")
    del fluid, lock, div
    torch.cuda.empty_cache()
    return secs


def _close_to_cpu(name, card, cpu, spread_of):
    """p and grad p of `card` against `cpu` (each (p, grad p, ...)) at
    the gen tolerances; where a point is off, the walks phase's
    _walk_close: nine points in ten, the rest within four times the
    walk's spread, spread_of() giving (p, grad p) of another key to take
    it from (run only then)."""
    other = None
    for j, (what, rtol, atol) in enumerate((("p", 2e-4, 2e-5),
                                            ("grad p", 2e-3, 2e-4))):
        got, want = card[j].cpu(), cpu[j]
        if bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
            continue
        other = other or spread_of()
        spread = float((want - other[j].cpu()).pow(2).mean().sqrt()) \
            / 2 ** 0.5
        _walk_close(f"{name} {what}", got, want, spread, rtol, atol, 0.9)


def _small_executors(Key):
    """(b) The threefry lockstep (fast_rng=False) on the mixed box (16
    points, 64 walks) and the adaptive pool on the obstacle scene (500
    walks, 4096 slots, which only reorder the work), card against CPU on
    the same streams at the walks phase's tolerances (_close_to_cpu); the
    adaptive run's walks against the fixed run's (gen, 250 pairs a
    generation). Returns seconds by check."""
    import dataclasses
    from nmcfluid_torch.wost import pool
    from nmcfluid_torch.wost.solver import (WalkSettings,
                                            estimate_solution_and_gradient)
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync()
        secs[name] = time.perf_counter() - t0
        return out
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.uniform(0.1, 1.9, (16, 2)).astype(np.float32))
    s = WalkSettings(walk_step_cap=256, ignore_dirichlet=False,
                     fast_rng=False)
    mixed = {dev: _mixed_scenes(dev)["mixed"][0] for dev in ("cuda", "cpu")}
    out = {dev: timed(f"threefry lockstep {dev}", lambda dev=dev:
                      estimate_solution_and_gradient(mixed[dev], s,
                                                     xs.to(dev), Key(7), 64))
           for dev in ("cuda", "cpu")}
    _close_to_cpu("threefry lockstep", out["cuda"], out["cpu"],
                  lambda: estimate_solution_and_gradient(
                      mixed["cpu"], s, xs, Key(8), 64))
    adapt = WalkSettings(walk_step_cap=64, adaptive_walks=1.0,
                         pool_slots=4096)
    fixed = dataclasses.replace(adapt, adaptive_walks=0.0,
                                gen_group_pairs=250)
    obstacle = {dev: pool.obstacle_scene(dev) for dev in ("cuda", "cpu")}

    def run(dev, settings, seed):
        scene, pts = obstacle[dev]
        return timed(f"{'fixed' if settings is fixed else 'adaptive'} {dev} "
                     f"key {seed}", lambda: estimate_solution_and_gradient(
                         scene, settings, pts, Key(seed), 500))
    pool.counts.update(dict.fromkeys(pool.counts, 0))
    card = run("cuda", adapt, 1)
    c = dict(pool.counts)
    cpu = run("cpu", adapt, 1)
    f1 = run("cuda", fixed, 1)
    _close_to_cpu("adaptive pool", card, cpu, lambda: run("cpu", adapt, 2))
    n_a, n_f = int(card[2].sum()), int(f1[2].sum())
    if not (bool((card[2].cpu() == cpu[2]).float().mean() >= 0.9)
            and n_a < n_f and int(card[2].min()) >= 16):
        raise AssertionError(f"adaptive pool: valid walks {card[2]} against "
                             f"the CPU's {cpu[2]} and the fixed run's {n_f}")
    print(f"small executors on the card: threefry lockstep on the mixed box "
          f"and the adaptive pool on the obstacle scene, card against CPU "
          f"on the same streams; adaptive walks {n_a} against the fixed "
          f"run's {n_f} ({n_a / n_f:.3f}); {c['rounds']} adaptive rounds, "
          f"{c['alive'] / (c['rounds'] * 32):.3f} of the points alive in "
          f"them; seconds "
          + json.dumps({k: round(v, 3) for k, v in secs.items()}),
          flush=True)
    return secs


def _ensemble_fit(tg_source, Key):
    """(c) One Taylor-Green source fit through _fit_source with
    fit_ensemble 2 at the shipped width and depth: two fit-kernel
    launches, counted, their device time by CUDA events (the fluid's
    profile); its parameters the mean of the two single fits on
    key.fold_in(0x5EED + j) (launched apart, not counted) within
    ENSEMBLE_ATOL. The first launch's inputs (start params, pool, lr) go
    through the kernel and the plain twin for 25 iterations, held at the
    Taylor-Green fit check's tolerance (rtol 2e-4, atol 1e-3). Returns
    the fit kernel's report entry on this path."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    fluid = tfluid.NeuralFluid(get_scene("taylorgreen"), device="cuda",
                               fit_ensemble=2)
    fluid.profile, fluid.stage_times = True, {}
    key, eps, n = Key(41), fluid.scene.bdry_eps, fluid.max_n_iters
    inputs = []
    fit = tfluid.fused_adam_fit

    def recorded(*args):
        inputs.append(args)
        return fit(*args)
    tfluid.fused_adam_fit = recorded
    fk.launches = 0
    try:
        _sync()
        t0 = time.perf_counter()
        pe, stats = tfluid._fit_source(fluid, tg_source.params, key, eps, 0)
        _sync()
        dt = time.perf_counter() - t0
    finally:
        tfluid.fused_adam_fit = fit
    launches = fk.launches
    if launches != 2 or len(inputs) != 2 or stats.executor != "fit kernel":
        raise AssertionError(f"fit_ensemble 2: {launches} launches, "
                             f"{stats.executor}")
    kernel_ms = fluid.stage_times["fit_kernel"] * 1e3 / (launches * n)
    batches = tfluid._SourceBatches(fluid, eps, 0)
    with torch.no_grad():
        singles = [tfluid._adam_fit_single(fluid, tg_source.params,
                                           key.fold_in(0x5EED + j),
                                           batches)[0] for j in range(2)]
    err_mean = max(float((e - (a + b) / 2.0).abs().max())
                   for le, la, lb in zip(pe, *singles)
                   for e, a, b in zip(le, la, lb))
    # the first launch's inputs, kernel against twin
    params0, cfg, pool, _, lr = inputs[0]
    lr = lr[:25] if isinstance(lr, torch.Tensor) else lr
    p_k, _ = fk.fused_adam_fit(params0, cfg, pool, 25, lr)
    _sync()
    t0 = time.perf_counter()
    p_r, _ = fk.reference_adam_fit(params0, cfg, pool, 25, lr)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 25
    err = 0.0
    for pair_k, pair_r in zip(p_k, p_r):
        for u, v in zip(pair_k, pair_r):
            torch.testing.assert_close(u, v, rtol=2e-4, atol=1e-3)
            err = max(err, float((u - v).abs().max()))
    print(f"fit_ensemble 2: one TG source fit ({n} iterations a fit) in "
          f"{dt:.3f} s, {launches} fit-kernel launches, "
          f"{kernel_ms:.5f} ms/iter on the card, loss "
          f"{float(stats.loss):.4e}; parameters against the mean of the two "
          f"single fits: max |d| {err_mean:.3e} (atol {ENSEMBLE_ATOL}); the "
          f"first launch's inputs, 25 iterations, kernel against twin "
          f"{err:.3e} (twin {plain_ms:.4f} ms/iter)", flush=True)
    if not err_mean <= ENSEMBLE_ATOL:
        raise AssertionError(f"fit_ensemble 2: {err_mean}")
    entry = _fit_entry("taylorgreen fit_ensemble=2", fluid, launches, None,
                       err, kernel_ms, plain_ms)
    entry["launches_per_fit"] = launches
    return entry


def _tools_quick():
    """(d) tools_walk_roofline and tools_fit_microbench in --quick mode:
    finite device and host times, the card named."""
    from nmcfluid_torch import tools_fit_microbench, tools_walk_roofline
    with tempfile.TemporaryDirectory() as tmp:
        roof = tools_walk_roofline.main(
            ["--quick", "--out", os.path.join(tmp, "roof.json")])
    micro = tools_fit_microbench.main(["--quick", "--scene", "taylorgreen"])
    rows = [roof["pool_width"]["advance"], roof["pool_width"]["trip"],
            *micro["ms_per_iter"].values()]
    for row in rows:
        for k in ("device_ms", "host_ms"):
            if k in row and not np.isfinite(row[k]):
                raise AssertionError(f"tools: {row}")
    adv, e2e = roof["pool_width"]["advance"], roof["end_to_end"]
    print(f"tools (--quick): an advance of {roof['config']['S_slots']} slots "
          f"{adv['host_ms']:.3f} ms host / {adv['device_ms']:.3f} ms device; "
          "a walk step end to end "
          + ", ".join(f"{a} {e2e[a]['host_ms_per_walk_step']:.3f} ms host"
                      for a in e2e)
          + f"; triad {roof['ceilings']['triad_GBs']:.0f} GB/s, f32 FMA "
          f"{roof['ceilings']['f32_fma_GFLOPs']:.0f} GFLOP/s; fresh-batch "
          f"iteration {micro['ms_per_iter']['full_advect_iter']['host_ms']:.3f}"
          f" ms host", flush=True)


def executors_phase(tg_source):
    """The executors phase: (a) the lockstep chunk, (b) the small
    executors, (c) the fit ensemble, (d) the two tools. Returns the fit
    kernel's report entry under fit_ensemble 2."""
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.utils.keys import Key
    t_phase = time.perf_counter()
    fk.launches = 0
    _lockstep_chunk(tg_source, Key)
    _small_executors(Key)
    if fk.launches:
        raise AssertionError("the walks launched the fit kernel")
    entry = _ensemble_fit(tg_source, Key)
    _tools_quick()
    print(f"executors phase done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entry


def cli_entries(fit_entries, launches):
    """Kernel-report entries of the fit kernel on the CLI's runs: the
    measurements of the scene's own path with the CLI's launch count."""
    out = []
    for scene in ("taylorgreen", "smoke"):
        entry = dict(next(e for e in fit_entries if e["path"] == scene))
        entry.update(path=f"cli {scene}", launches=launches[scene])
        out.append(entry)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.utils import cuda_build
    from nmcfluid_torch.wost import pallas_probe as pp

    t_start = time.perf_counter()
    card = _card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    def build(name, sources):
        t0 = time.perf_counter()
        so = cuda_build.library_path(name, sources)
        return so, time.perf_counter() - t0
    with ThreadPoolExecutor() as ex:
        builds = [ex.submit(build, "fitkernel", fk._SOURCES),
                  ex.submit(build, "gather", pp._SOURCES)]
        for b in builds:
            so, dt = b.result()
            print(f"built {so} in {dt:.1f} s", flush=True)
    fk.load_library()
    pp.load_library()

    # ---- the gather probe's entry point at the probe's n and a
    # generation's lanes, on a random table and on the radial table with
    # the walk's rows: every form held exactly against table[idx]
    pp.launches.update(dict.fromkeys(pp.VARIANTS, 0))
    fk.launches = 0
    probe = {(kind, n): pp.main(["--table", kind, "--n", str(n)])
             for kind in ("random", "radial") for n in GATHER_N}
    gather_launches = dict(pp.launches)
    for key, res in probe.items():
        if not all(r["ok"] for r in res.values()):
            raise AssertionError(f"probe {key}: {res}")
    if not all(gather_launches.values()) or fk.launches:
        raise AssertionError(f"probe launches {gather_launches}, fit "
                             f"{fk.launches}")
    gather_entries = gather_report(pp, probe, gather_launches)
    torch.cuda.empty_cache()

    tg_entry, tg_step1, tg_errors, tg_source = taylor_green_phase(
        cuda_build)
    cli_launches = cli_phase(tg_step1, tg_errors)
    sources = {"taylorgreen": tg_source}
    fit_entries = [tg_entry]
    for path in PATHS:
        entry, sources[path[0]] = path_phase(*path)
        fit_entries.append(entry)
    fit_entries += cli_entries(fit_entries, cli_launches)
    t0 = time.perf_counter()
    bands = {path[0]: path[5] for path in PATHS}
    for name, projection in PROJECTIONS:
        entry = next(e for e in fit_entries if e["path"] == name)
        fit_entries.append(projection_phase(
            name, projection, sources[name], entry, bands.get(name)))
    print(f"projections phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    fit_entries += walks_phase(sources, fit_entries)
    fit_entries += soups_phase(sources, fit_entries, tg_errors[1])
    fit_entries.append(baselines_phase(tg_entry))
    fit_entries.append(executors_phase(sources["taylorgreen"]))
    print(f"all phases done in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": fit_entries + gather_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
