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
   table[idx] and timed; checks that each kernel launched.
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

Any failed check raises, so the script exits non-zero. The last three
lines are the kernel report ({"kernels": [...]}, one entry per kernel with
its launches, error, times and bound), the card's name and power limit as
nvidia-smi gives them, and {"ok": true, "device": {...}}.
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


def _tg_pool(fluid, K, seed):
    """A Taylor-Green-like pool from a numpy seed: points in the box, the
    scene's affine hard-BC map, the initial velocity plus noise as target,
    unit weights."""
    rng = np.random.default_rng(seed)
    B = fluid.n_batch
    lo, hi = fluid.scene.scene_size[0], fluid.scene.scene_size[1]
    x = torch.from_numpy(rng.uniform(lo, hi, (K, B, 2)).astype(np.float32))
    x = x.cuda()
    A, c = fluid.velocity_affine(x, eps=fluid.scene.bdry_eps, t=0)
    noise = torch.from_numpy(
        rng.normal(0.0, 0.05, (K, B, 2)).astype(np.float32)).cuda()
    tgt = fluid.scene.source_velocity(x) + noise
    return (x, A.contiguous(), c.contiguous(), tgt,
            torch.ones((K, B), device="cuda"))


def check_fit_kernel(fluid, fk, tfluid, params):
    """Kernel vs plain twin, 25 iterations at lr 1e-3: params to rtol 2e-4
    / atol 1e-3 and loss to rtol 1e-2 (tests/test_fitkernel.py's TG-family
    tolerances); a second call must agree bit for bit. Then the kernel as
    the main path runs it: a 10,000-iteration fit on a K = 512 pool with
    the main path's lr. Returns (max_abs_err, kernel ms/iter, twin
    ms/iter)."""
    pool = _tg_pool(fluid, 8, seed=0)
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
            torch.testing.assert_close(u, v, rtol=2e-4, atol=1e-3)
            err = max(err, float((u - v).abs().max()))
            if not torch.equal(u, w):
                raise AssertionError("two fit-kernel calls differ")
    if not torch.equal(l_k, l_k2):
        raise AssertionError("two fit-kernel calls give other losses")
    rel = abs(float(l_k) - float(l_r)) / abs(float(l_r))
    if not rel <= 1e-2:
        raise AssertionError(f"fit loss: kernel {float(l_k)} vs twin "
                             f"{float(l_r)}")
    # the main path's fit: K = 512 pool, max_n_iters iterations, its lr
    pool = _tg_pool(fluid, fluid.fit_pool, seed=1)
    lr = tfluid._fit_lr_array(fluid)
    n = fluid.max_n_iters
    fk.fused_adam_fit(params, cfg, pool, 20, lr)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    fk.fused_adam_fit(params, cfg, pool, n, lr)
    ev1.record()
    _sync()
    kernel_ms = ev0.elapsed_time(ev1) / n
    print(f"fit kernel vs twin: max_abs_err {err:.3e}, loss {float(l_k):.6e}"
          f" vs {float(l_r):.6e}, repeat bit-identical; ms/iter kernel "
          f"{kernel_ms:.5f} ({n} iterations, K = {fluid.fit_pool}), twin "
          f"{plain_ms:.4f}", flush=True)
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


def check_small_input(tfluid, scene, Key):
    """The divergence grid and one WoSt chunk on the card against the same
    stage on the CPU, on a small input with the same keys."""
    kw = dict(sample_resolution=16, wost_resolution=16, div_resolution=64,
              n_walks=48, max_n_iters=50, fit_pool=8)
    gpu = tfluid.NeuralFluid(scene, device="cuda", **kw)
    cpu = tfluid.NeuralFluid(scene, device="cpu", **kw)
    params = gpu.init_state(3).params
    params_cpu = [(W.cpu(), b.cpu()) for W, b in params]
    div_g = tfluid._divergence_grid(gpu, params, gpu.scene.bdry_eps, 1)
    div_c = tfluid._divergence_grid(cpu, params_cpu, cpu.scene.bdry_eps, 1)
    torch.testing.assert_close(div_g.cpu(), div_c, rtol=1e-4, atol=5e-5)
    pts_g, _, p_g, g_g = tfluid._pressure_solve(gpu, (div_g,), Key(11))
    pts_c, _, p_c, g_c = tfluid._pressure_solve(cpu, (div_g.cpu(),), Key(11))
    torch.testing.assert_close(pts_g.cpu(), pts_c, rtol=2e-7, atol=0)
    # gen tolerances (tests/test_gen.py): same streams, other sum order
    torch.testing.assert_close(p_g.cpu(), p_c, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(g_g.cpu(), g_c, rtol=2e-3, atol=2e-4)
    print("small input: divergence grid and WoSt chunk on the card match "
          "the CPU", flush=True)


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
    touch. (onehot's own 128 x 4 FMAs a lane are its form's cost, not the
    function's.)"""
    return _bound(20 * idx.shape[0] + 16 * torch.unique(idx).numel(), 0)


def gather_report(pp, probe, launches):
    """Kernel-report entries of the four gathers at n = GATHER_N[-1] on the
    random table, all from the probe's runs: the kernel's time, its plain
    version's, torch.index_select's, the largest error over every run, and
    the bound from the run's indices."""
    n = GATHER_N[-1]
    res = probe[("random", n)]
    _, idx = pp.probe_inputs("random", n, "cuda")
    bound_ms, bound_by = _gather_bound(idx)
    lines = {"rows": 38, "lanes": 44, "scalar": 52, "onehot": 59}
    out = []
    for variant in pp.VARIANTS:
        out.append({
            "name": f"gather_{variant}_k", "route": "cuda",
            "source": "nmcfluid_torch/csrc/gather.cu",
            "replaces": f"nmcfluid/wost/pallas_probe.py:{lines[variant]}",
            "launches": launches[variant],
            "max_abs_err": max(r[variant]["err"] for r in probe.values()),
            "ms": res[variant]["ms"],
            "plain_ms": res[pp.PLAIN[variant]]["ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": res["torch"]["ms"], "n": n})
        print(f"gather {variant}: {out[-1]['ms']:.5f} ms kernel, "
              f"{out[-1]['plain_ms']:.5f} ms plain, "
              f"{out[-1]['library_ms']:.5f} ms torch.index_select, bound "
              f"{bound_ms:.5f} ms ({bound_by}) at n = {n}", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.transport.density import (raw_velocity_grid,
                                                  tg_velocity_error)
    from nmcfluid_torch.utils import cuda_build
    from nmcfluid_torch.utils.keys import Key
    from nmcfluid_torch.wost import pallas_probe as pp

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

    scene = get_scene("taylorgreen")
    fluid = tfluid.NeuralFluid(scene, device="cuda")
    cfg = fluid.siren_cfg
    plan = fk.fit_plan(cfg.in_features, cfg.out_features,
                       cfg.hidden_features, cfg.num_hidden_layers,
                       fluid.n_batch, fluid.fit_pool, fluid.max_n_iters,
                       fk._sm_count(torch.device("cuda")))
    fit_build_report(cuda_build.build_log("fitkernel", fk._SOURCES), plan,
                     fk._NT)
    err, kernel_ms, plain_ms = check_fit_kernel(
        fluid, fk, tfluid, fluid.init_state(1).params)
    check_small_input(tfluid, scene, Key)

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
    pp.launches.update(dict.fromkeys(pp.VARIANTS, 0))
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
              f"{tg_error(state.params):.6e}", flush=True)
    launches = fk.launches
    if launches != 5 or per_frame != [2, 2]:
        raise AssertionError(f"expected 5 fit-kernel launches (1 source + "
                             f"2 per step), got {launches} ({per_frame} "
                             f"in the steps)")
    pts, p, grad_p, div = fluid._last_projection
    for name, t in [("P", state.P), ("p", p), ("grad_p", grad_p),
                    ("div_grid", div)] + [
                        (f"param{i}", a) for i, pair in
                        enumerate(state.params) for a in pair]:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")
    if tuple(div.shape) != (1000, 1000) or tuple(p.shape) != (512 * 512,):
        raise AssertionError(f"shapes: div {tuple(div.shape)}, p "
                             f"{tuple(p.shape)}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)

    bound_ms, bound_by, bound_tc_ms = _fit_bound(cfg, fluid.n_batch)
    print(f"fit kernel: {kernel_ms:.5f} ms/iter, {bound_ms / kernel_ms:.1%} "
          f"of the f32 bound ({bound_ms:.5f} ms), "
          f"{bound_tc_ms / kernel_ms:.1%} of the 3xTF32 bound "
          f"({bound_tc_ms:.5f} ms); {per_frame[0]} launches a TG frame",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "fit_persistent (fused_adam_fit)", "route": "cuda",
        "source": "nmcfluid_torch/csrc/fitkernel.cu",
        "replaces": "nmcfluid/sim/fitkernel.py:317",
        "launches": launches, "launches_per_tg_frame": per_frame[0],
        "max_abs_err": err, "ms": kernel_ms, "ms_per": "Adam iteration",
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_3xtf32_ms": bound_tc_ms,
        # no single PyTorch call computes an Adam iteration of a SIREN
        "library_ms": None}] + gather_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
