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
   K = 8), checks that two calls agree bit for bit, and times it as the
   main path runs it: one 10,000-iteration fit on a K = 512 pool.
5. Holds the divergence grid and one walk-on-stars chunk on the card
   against the same stages on the CPU, on a small input.
6. Drives the main path at the shipped Taylor-Green width and depth:
   get_scene, NeuralFluid(device="cuda"), init_state, add_source and two
   steps, with the per-stage wall-clock (and the fit kernel's own device
   time, "fit_kernel") and the Taylor-Green velocity error of each step,
   and checks that every phase fit ran on the kernel, one launch a fit.
7. The karman path: steps 4 and 5 at karman's shapes (a 2 x 128 SIREN,
   16,384-point batches, the channel with its circle), then get_scene
   ("karman"), NeuralFluid(device="cuda"), init_state, add_source, the
   ramp width halved as the JAX CLI does, and one step at the shipped
   width (512^2 pressure points x 500 walks, a 1000 x 399 divergence
   grid, 10,000-iteration fits on K = 512 pools with fresh weights each):
   stage times, fit-kernel launches (3), P, kinetic energy, the source
   fit's error against the inflow, peak memory.

Any failed check raises, so the script exits non-zero. The last three
lines are the kernel report ({"kernels": [...]}, one entry per kernel with
its launches, error, times and bound; the fit kernel has one entry per
path), the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM TF32 tensor cores, dense
GATHER_N = (65536, 524288)     # the probe's n; a walk generation's lanes


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync():
    torch.cuda.synchronize()


def _pool(fluid, K, seed):
    """A pool of the scene's shapes from a numpy seed: points in the box,
    the scene's affine hard-BC map at its ramp width, the initial velocity
    plus noise as target, weight 1 in the fluid and 0 inside obstacles."""
    rng = np.random.default_rng(seed)
    B = fluid.n_batch
    ss = fluid.scene.scene_size
    x = rng.uniform((ss[0], ss[2]), (ss[1], ss[3]), (K, B, 2))
    x = torch.from_numpy(x.astype(np.float32)).cuda()
    A, c = fluid.velocity_affine(x, eps=fluid.scene.bdry_eps, t=0)
    noise = torch.from_numpy(
        rng.normal(0.0, 0.05, (K, B, 2)).astype(np.float32)).cuda()
    tgt = fluid.scene.source_velocity(x) + noise
    return (x, A.contiguous(), c.contiguous(), tgt,
            fluid.scene.fluid_mask(x).to(torch.float32))


def check_fit_kernel(fluid, fk, tfluid, params, atol):
    """Kernel vs plain twin on a K = 8 pool of the scene's shapes, 25
    iterations at lr 1e-3: params to rtol 2e-4 / `atol` and loss to rtol
    1e-2 (tests/test_fitkernel.py's tolerances for the scene's family); a
    second call must agree bit for bit. Then the kernel as the main path
    runs it: a max_n_iters fit on a K = fit_pool pool with the main path's
    lr. Returns (max_abs_err, kernel ms/iter, twin ms/iter)."""
    pool = _pool(fluid, 8, seed=0)
    cfg = fluid.siren_cfg
    p_k, l_k = fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)
    p_k2, l_k2 = fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)
    _sync()
    t0 = time.perf_counter()
    p_r, l_r = fk.reference_adam_fit(params, cfg, pool, 25, 1e-3)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 25
    err = 0.0
    for (a, b), (c, d), (e, f) in zip(p_k, p_r, p_k2):
        for u, v, w in ((a, c, e), (b, d, f)):
            torch.testing.assert_close(u, v, rtol=2e-4, atol=atol)
            err = max(err, float((u - v).abs().max()))
            if not torch.equal(u, w):
                raise AssertionError("two fit-kernel calls differ")
    if not torch.equal(l_k, l_k2):
        raise AssertionError("two fit-kernel calls give other losses")
    rel = abs(float(l_k) - float(l_r)) / abs(float(l_r))
    if not rel <= 1e-2:
        raise AssertionError(f"fit loss: kernel {float(l_k)} vs twin "
                             f"{float(l_r)}")
    # the main path's fit: K = fit_pool pool, max_n_iters iterations, its lr
    pool = _pool(fluid, fluid.fit_pool, seed=1)
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
          f"(atol {atol:g}), loss {float(l_k):.6e} vs {float(l_r):.6e}, "
          f"repeat bit-identical; ms/iter kernel {kernel_ms:.5f} ({n} "
          f"iterations, K = {fluid.fit_pool}), twin {plain_ms:.4f}",
          flush=True)
    return err, kernel_ms, plain_ms


def fit_build_report(log, plan, threads):
    """Each fit kernel's registers, stack and spills from ptxas -v, and the
    dynamic shared memory the plan gives it at Taylor-Green shapes."""
    kernels, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*fit_persistentILi(\d)"
                      r"ELb([01])E\S*)'", line)
        if m:
            cur = {"npw": int(m.group(2)), "recompute": m.group(3) == "1"}
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
    for k in sorted(kernels, key=lambda k: (k["recompute"], k["npw"])):
        print(f"fit_persistent<H padded to {32 * k['npw']}, "
              f"{'recompute' if k['recompute'] else 'store'}>: "
              f"{k.get('registers')} registers, {k.get('stack')} B stack, "
              f"{k.get('spill_stores')} B spill stores, "
              f"{k.get('spill_loads')} B spill loads", flush=True)
    print(f"fit kernel at Taylor-Green shapes: {plan.G} blocks x "
          f"{threads} threads, {plan.smem_bytes} B dynamic shared memory a "
          f"block", flush=True)
    return kernels


def check_small_input(tfluid, scene, Key, eps):
    """The divergence grid and one WoSt chunk on the card against the same
    stage on the CPU, on a small input with the same keys, at ramp width
    eps."""
    kw = dict(sample_resolution=16, wost_resolution=16, div_resolution=64,
              n_walks=48, max_n_iters=50, fit_pool=8)
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
    # gen tolerances (tests/test_gen.py): same streams, other sum order
    torch.testing.assert_close(p_g.cpu(), p_c, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(g_g.cpu(), g_c, rtol=2e-3, atol=2e-4)
    print(f"{scene.name} small input: divergence grid "
          f"{tuple(div_g.shape)} and WoSt chunk on the card match the CPU",
          flush=True)


def _bound(n_bytes, flops):
    """(bound_ms, bound_by): the least time of the card's memory rate and
    f32 rate for this work, at the published peaks (700 W)."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def _fit_bound(cfg, B):
    """Least time of one Adam iteration at batch B: forward MACs of the
    SIREN, backward twice that; bytes of one pool batch and of the params,
    m and v read and written once. Returns (bound_ms, bound_by) at the f32
    rate and the 3xTF32 bound: three TF32 products for each f32 one on
    the tensor cores."""
    H, Lh, D_in, D_out = (cfg.hidden_features, cfg.num_hidden_layers,
                          cfg.in_features, cfg.out_features)
    macs = D_in * H + Lh * H * H + H * D_out
    n_params = macs + (Lh + 1) * H + D_out
    n_bytes = 4 * (B * (D_in + D_out * D_out + 3 * D_out + 1)
                   + 6 * n_params)
    flops = 2 * 3 * macs * B
    return _bound(n_bytes, flops) + (
        max(n_bytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3,)


def _gather_bound(idx):
    """All four forms compute out[b] = table[idx[b]], so one bound: indices
    read and rows written once, and the table rows this run's indices
    touch. (What a form does beyond that, such as onehot's sort and its
    reads of the whole table from L2, is the form's cost, not the
    function's.)"""
    return _bound(20 * idx.shape[0] + 16 * torch.unique(idx).numel(), 0)


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
          f"({bound_tc_ms:.5f} ms); {per_frame} launches a frame",
          flush=True)
    return {
        "name": "fit_persistent (fused_adam_fit)", "route": "cuda",
        "source": "nmcfluid_torch/csrc/fitkernel.cu",
        "replaces": "nmcfluid/sim/fitkernel.py:317", "path": path,
        "launches": launches, "launches_per_frame": per_frame,
        "max_abs_err": err, "ms": kernel_ms, "ms_per": "Adam iteration",
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_3xtf32_ms": bound_tc_ms,
        # no single PyTorch call computes an Adam iteration of a SIREN
        "library_ms": None}


def _walk_report(wost_s):
    """The walk's generations, steps and lanes since the counts were
    zeroed, and the solve's wall-clock split by step; zeroes them."""
    from nmcfluid_torch.wost import gen
    c = dict(gen.counts)
    gen.counts.update(dict.fromkeys(gen.counts, 0))
    return (f"walk: {c['generations']} generations, {c['steps']} steps "
            f"({c['steps'] / max(1, c['generations']):.1f} a generation), "
            f"{c['lane_steps'] / max(1, c['steps']):.0f} active lanes a "
            f"step on average, {wost_s * 1e3 / max(1, c['steps']):.3f} ms "
            f"of wost_solve a step")


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


def taylor_green_phase(cuda_build):
    """The fit kernel and the small input at Taylor-Green shapes, then the
    Taylor-Green path at full width and depth: add_source + 2 steps, 5
    fit-kernel launches. Returns the fit kernel's report entry."""
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
    print(f"add_source: {wall:.2f} s, TG velocity error "
          f"{tg_error(state.params):.6e}", flush=True)
    fluid.profile = True
    per_frame = []
    for s in range(2):
        fluid.stage_times = {}
        _walk_report(0.0)
        before = fk.launches
        t0 = time.perf_counter()
        state = fluid.step(state)
        _sync()
        wall = time.perf_counter() - t0
        per_frame.append(fk.launches - before)
        stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
        print(f"step {s + 1}: {wall:.2f} s, stages {json.dumps(stages)}, "
              f"fit-kernel launches {per_frame[-1]}, P "
              f"{float(state.P):.6e}, TG velocity error "
              f"{tg_error(state.params):.6e}; "
              f"{_walk_report(stages['wost_solve'])}", flush=True)
    launches = fk.launches
    if launches != 5 or per_frame != [2, 2]:
        raise AssertionError(f"expected 5 fit-kernel launches (1 source + "
                             f"2 per step), got {launches} ({per_frame} "
                             f"in the steps)")
    _check_finite(state, fluid._last_projection)
    _, p, _, div = fluid._last_projection
    if tuple(div.shape) != (1000, 1000) or tuple(p.shape) != (512 * 512,):
        raise AssertionError(f"shapes: div {tuple(div.shape)}, p "
                             f"{tuple(p.shape)}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    return _fit_entry("taylorgreen", fluid, launches, per_frame[0], err,
                      kernel_ms, plain_ms)


def karman_phase():
    """The fit kernel and the small input at karman shapes, then the
    karman path at full width: add_source, the ramp width halved as the
    JAX CLI does (nmcfluid/run.py:498-500), one step; 3 fit-kernel
    launches, every phase fit on fresh weights. Returns the fit kernel's
    report entry."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.sim.sampling import uniform_grid
    from nmcfluid_torch.utils.keys import Key

    scene = get_scene("karman")
    fluid = tfluid.NeuralFluid(scene, device="cuda")
    plan = _plan(fk, fluid)
    if (plan.recompute, plan.n_wbuf, plan.tiles_per_block) != (False, 1, 4):
        raise AssertionError(f"karman fit plan {plan}")
    print(f"fit kernel at karman shapes: {plan.G} blocks x {fk._NT} "
          f"threads, {plan.tiles_per_block} tiles a block, store mode, "
          f"{plan.n_wbuf} weight buffer, {plan.smem_bytes} B dynamic shared "
          f"memory a block", flush=True)
    err, kernel_ms, plain_ms = check_fit_kernel(
        fluid, fk, tfluid, fluid.init_state(1).params, atol=2e-6)
    check_small_input(tfluid, scene, Key, scene.bdry_eps / 2)

    # the vel_vis grid (200 x 80) and the inflow on it, inside the fluid
    res = scene.vel_vis_resolution
    grid = uniform_grid(scene.scene_size, res, device="cuda")
    inside = scene.fluid_mask(grid)
    src = scene.source_velocity(grid)

    def energy(u):
        return float(0.5 * torch.mean(torch.sum(u[inside] ** 2, -1)))

    # ---- the karman path at full width
    fk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fluid.add_source(fluid.init_state(0))
    _sync()
    wall = time.perf_counter() - t0
    u = tfluid._velocity_grid(fluid, state.params, state.eps, 0, res, False)
    src_err = float(torch.sum((u - src)[inside] ** 2)
                    / torch.sum(src[inside] ** 2))
    print(f"karman add_source: {wall:.2f} s, source-fit error {src_err:.6e} "
          f"(relative squared, {tuple(grid.shape[:2])} grid, inside the "
          f"fluid)", flush=True)
    # an untrained field reads ~1: only a broken fit crosses 5e-2
    if not src_err < 5e-2:
        raise AssertionError(f"karman source-fit error {src_err} >= 5e-2")
    state = state._replace(eps=state.eps / 2)
    fluid.profile = True
    fluid.stage_times = {}
    _walk_report(0.0)
    t0 = time.perf_counter()
    state = fluid.step(state)
    _sync()
    wall = time.perf_counter() - t0
    per_frame = fk.launches - 1
    stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
    u = tfluid._velocity_grid(fluid, state.params, state.eps,
                              state.timestep, res, False)
    ratio = energy(u) / energy(src)
    print(f"karman step 1: {wall:.2f} s, stages {json.dumps(stages)}, "
          f"fit-kernel launches {per_frame}, P {float(state.P):.6e}, "
          f"kinetic energy {float(fluid.kinetic_energy(state)):.6e}, "
          f"0.5 mean|u|^2 {energy(u):.6e} = {ratio:.4f} x the inflow's; "
          f"{_walk_report(stages['wost_solve'])}", flush=True)
    if fk.launches != 3 or per_frame != 2:
        raise AssertionError(f"expected 3 fit-kernel launches (1 source + "
                             f"2 in the step), got {fk.launches}")
    _check_finite(state, fluid._last_projection)
    _, p, _, div = fluid._last_projection
    if tuple(div.shape) != (1000, 399) or tuple(p.shape) != (512 * 512,):
        raise AssertionError(f"shapes: div {tuple(div.shape)}, p "
                             f"{tuple(p.shape)}")
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError(f"karman 0.5 mean|u|^2 after the step is "
                             f"{ratio} x the inflow's")
    print(f"karman peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return _fit_entry("karman", fluid, fk.launches, per_frame, err,
                      kernel_ms, plain_ms)


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

    tg_entry = taylor_green_phase(cuda_build)
    karman_entry = karman_phase()
    print(f"all phases done in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [tg_entry, karman_entry]
                      + gather_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
