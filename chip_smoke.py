"""Smoke run of the PyTorch port on one CUDA card (the H100 it targets).

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the port's CUDA kernels from nmcfluid_torch/csrc/ (nvcc, sm_90a).
3. Holds the fused phase-fit kernel against its plain PyTorch twin on the
   card at Taylor-Green shapes (6 x 64 SIREN, 4096-point batches, K = 8),
   and times both per fit iteration.
4. Holds the divergence grid and one walk-on-stars chunk on the card
   against the same stages on the CPU, on a small input.
5. Drives the main path at the shipped Taylor-Green width and depth:
   get_scene, NeuralFluid(device="cuda"), init_state, add_source and two
   steps, with the per-stage wall-clock and the Taylor-Green velocity
   error of each step, and checks that every phase fit ran on the kernel.

Any failed check raises, so the script exits non-zero. The last two lines
are the kernel report and {"ok": true, "device": {...}}.
"""
import json
import subprocess
import time

import numpy as np
import torch


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


def check_fit_kernel(fluid, fk, params):
    """Kernel vs plain twin, 25 iterations at lr 1e-3: params to rtol 2e-4
    / atol 1e-3 and loss to rtol 1e-2 (tests/test_fitkernel.py's TG-family
    tolerances). Returns (max_abs_err, kernel ms/iter, twin ms/iter)."""
    pool = _tg_pool(fluid, 8, seed=0)
    cfg = fluid.siren_cfg
    p_k, l_k = fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)
    _sync()
    t0 = time.perf_counter()
    p_r, l_r = fk.reference_adam_fit(params, cfg, pool, 25, 1e-3)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 25
    err = 0.0
    for (a, b), (c, d) in zip(p_k, p_r):
        for u, v in ((a, c), (b, d)):
            torch.testing.assert_close(u, v, rtol=2e-4, atol=1e-3)
            err = max(err, float((u - v).abs().max()))
    rel = abs(float(l_k) - float(l_r)) / abs(float(l_r))
    if not rel <= 1e-2:
        raise AssertionError(f"fit loss: kernel {float(l_k)} vs twin "
                             f"{float(l_r)}")
    # time the kernel at TG shapes over a longer fit (events on the stream)
    fk.fused_adam_fit(params, cfg, pool, 20, 1e-5)
    n = 1000
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    fk.fused_adam_fit(params, cfg, pool, n, 1e-5)
    ev1.record()
    _sync()
    kernel_ms = ev0.elapsed_time(ev1) / n
    print(f"fit kernel vs twin: max_abs_err {err:.3e}, loss {float(l_k):.6e}"
          f" vs {float(l_r):.6e}; ms/iter kernel {kernel_ms:.4f}, "
          f"twin {plain_ms:.4f}", flush=True)
    return err, kernel_ms, plain_ms


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

    card = _card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    so = cuda_build.library_path("fitkernel", fk._SOURCES)
    fk.load_library()
    print(f"built {so} in {time.perf_counter() - t0:.1f} s", flush=True)

    scene = get_scene("taylorgreen")
    fluid = tfluid.NeuralFluid(scene, device="cuda")
    err, kernel_ms, plain_ms = check_fit_kernel(
        fluid, fk, fluid.init_state(1).params)
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fluid.init_state(0)
    state = fluid.add_source(state)
    _sync()
    wall = time.perf_counter() - t0
    print(f"add_source: {wall:.2f} s, TG velocity error "
          f"{tg_error(state.params):.6e}", flush=True)
    fluid.profile = True
    for s in range(2):
        fluid.stage_times = {}
        t0 = time.perf_counter()
        state = fluid.step(state)
        _sync()
        wall = time.perf_counter() - t0
        stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}
        print(f"step {s + 1}: {wall:.2f} s, stages {json.dumps(stages)}, "
              f"P {float(state.P):.6e}, TG velocity error "
              f"{tg_error(state.params):.6e}", flush=True)
    launches = fk.launches
    if launches != 5:
        raise AssertionError(f"expected 5 fit-kernel launches (1 source + "
                             f"2 per step), got {launches}")
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

    print(json.dumps({"kernels": [{
        "name": "fused_adam_fit (fit_fwd_bwd + fit_adam)", "route": "cuda",
        "source": "nmcfluid_torch/csrc/fitkernel.cu",
        "replaces": "nmcfluid/sim/fitkernel.py:317",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
