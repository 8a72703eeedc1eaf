"""Where a walk step's time goes on the card (port of
nmcfluid/tools_walk_roofline.py).

    python -m nmcfluid_torch.tools_walk_roofline [--out PATH] [--quick]
        [--device cuda|cpu] [--skip_e2e]

On a Taylor-Green cloud of one pressure chunk (65,536 points; 4,096 with
--quick) at the shipped walk settings (500 walks; 16 with --quick), with
a constant divergence grid as the source, it measures:

  1. the walker pool's trip taken apart at its width S = min(8 N, 2^20)
     slots: one `_advance` step of every slot, with and without the
     source term, the scatter/refill stage, the S-wide start states, and
     the whole trip as the pool runs it;
  2. the advance step's parts at that width: ray_intersect, star_radius,
     the distance bound, the Yukawa Green's function bundle, six fastrand
     draws and the divergence grid's source lookup;
  3. the card's own ceilings measured the same way: triad bandwidth (b =
     b + 1.0001 a), the float32 FMA rate (a float32 GEMM with TF32 off,
     which cuBLAS runs on the FMA units) and a per-lane gather from a 4 MB
     table (the divergence grid's access);
  4. the production chunk end to end on the pool and on the generation
     executor: seconds, walk steps, and the device's busy time over the
     chunk from one torch.profiler window, so the device's idle share.

Each item is timed twice: its device time by CUDA events, the calls
queued behind a sleep kernel long enough to hold the card while the host
issues them (so the events see the card's work, not the host's launch
rate; as many calls as CUDA's launch queue holds), and its host
wall time per call with the card drained after each call; beside them
the kernels' own time and count a call from a torch.profiler window and
the host syncs a call makes (torch's sync debug mode). --quick opens no
profiler window (its first costs seconds).
The JSON (by default docs/walk_roofline_torch_r15.json) is headed by the
card's name and power limit as nvidia-smi gives them. Without a card it
refuses; --device cpu rehearses every item on the CPU at --quick's size,
with host times only (every device number "not measured").
"""
import argparse
import dataclasses
import json
import os
import subprocess
import time
import warnings

import numpy as np
import torch

NOT_MEASURED = "not measured"


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Times a call on `dev` (see the module docstring); `n` calls a
    measurement, `profile` adds each call's kernel time from a
    torch.profiler window. On the card the sleep kernel's cycles a
    millisecond are calibrated once."""

    def __init__(self, dev, n=8, profile=True):
        self.dev, self.n, self.profile = dev, n, profile
        self.cycles_per_ms = None
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(1_000_000)            # warm
            ev[0].record()
            torch.cuda._sleep(10_000_000)
            ev[1].record()
            ev[1].synchronize()
            self.cycles_per_ms = 10_000_000 / ev[0].elapsed_time(ev[1])

    def host_syncs(self, fn):
        """Host syncs one call makes, by torch's sync debug mode."""
        if self.dev.type != "cuda":
            return NOT_MEASURED
        _sync(self.dev)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        _sync(self.dev)
        return sum("synchroniz" in str(x.message) for x in w)

    def __call__(self, fn, n=None, warm=2):
        """{"host_ms", "device_ms", "queued", "busy_ms", "kernels",
        "syncs"} of one call: the host's wall time per call, drained after
        each; the device's time per call by CUDA events over calls queued
        behind the sleep (as many as CUDA's launch queue of about a
        thousand launches holds; queued: whether the host issued them all
        before the sleep ended, else the events also saw the card wait);
        the kernels' own time per call and the kernels a call launches,
        from a profiler window; the host syncs a call makes."""
        n = n or self.n
        for _ in range(warm):
            fn()
        _sync(self.dev)
        host = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            _sync(self.dev)
            host.append(time.perf_counter() - t0)
        host_ms = float(np.median(host)) * 1e3
        out = {"host_ms": host_ms, "device_ms": NOT_MEASURED,
               "queued": NOT_MEASURED, "busy_ms": NOT_MEASURED,
               "kernels": NOT_MEASURED, "syncs": self.host_syncs(fn)}
        if self.dev.type != "cuda":
            return out
        if self.profile:
            out["busy_ms"], out["kernels"] = device_busy(fn, self.dev)
        k = out["kernels"] if out["kernels"] != NOT_MEASURED else 1000
        n_q = max(1, min(n, 900 // max(1, k)))
        sleep_ms = 1.5 * host_ms * n_q + 5.0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(int(sleep_ms * self.cycles_per_ms))
        ev[0].record()
        t0 = time.perf_counter()
        for _ in range(n_q):
            fn()
        t_issue = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        ev[1].synchronize()
        out["device_ms"] = ev[0].elapsed_time(ev[1]) / n_q
        out["queued"] = bool(t_issue < sleep_ms)
        return out


def device_busy(fn, dev):
    """(the device's busy ms over one call of fn, kernels launched) from
    one torch.profiler window: the sum of the kernels' own device time
    (overlaps counted twice; one stream here). Off the card, or when the
    profiler records no device time: NOT_MEASURED."""
    if dev.type != "cuda":
        return NOT_MEASURED, NOT_MEASURED
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            n += e.count
    return (us / 1e3, n) if us > 0.0 else (NOT_MEASURED, NOT_MEASURED)


def machine_ceilings(timer, dev, quick):
    """The card's triad bandwidth (GB/s), float32 FMA rate (GFLOP/s) and
    per-lane gather rate from a 4 MB table (Mlanes/s); off the card
    NOT_MEASURED."""
    if dev.type != "cuda":
        return {k: NOT_MEASURED for k in
                ("triad_GBs", "f32_fma_GFLOPs", "gather_Mlanes_s")}
    out = {}
    n = (1 << 24) if quick else (1 << 26)
    a = torch.arange(n, dtype=torch.float32, device=dev)
    b = torch.ones(n, dtype=torch.float32, device=dev)
    t = timer(lambda: b.add_(a, alpha=1.0001))
    out["triad"] = t
    out["triad_GBs"] = 3 * 4 * n / (t["device_ms"] * 1e-3) / 1e9
    m = 4096 if quick else 8192
    x = torch.randn(m, m, device=dev)
    y = torch.randn(m, m, device=dev)
    z = torch.empty(m, m, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = timer(lambda: torch.mm(x, y, out=z))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["f32_gemm"] = t
    out["f32_fma_GFLOPs"] = 2.0 * m ** 3 / (t["device_ms"] * 1e-3) / 1e9
    S, T = 1 << 19, 1 << 20
    tbl = torch.ones(T, dtype=torch.float32, device=dev)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, T, size=S)).to(dev)
    g = torch.empty(S, dtype=torch.float32, device=dev)
    t = timer(lambda: torch.index_select(tbl, 0, idx, out=g))
    out["gather"] = t
    out["gather_Mlanes_s"] = S / (t["device_ms"] * 1e-3) / 1e6
    return out


def _chunk(args, dev):
    """(wost scene, settings, points, key, source args) of the scene's
    chunk."""
    from .scenes import get_scene
    from .sim import sampling
    from .sim.fluid import NeuralFluid
    from .utils.keys import Key
    scene = get_scene(args.scene)
    fluid = NeuralFluid(scene, device=dev)
    N = args.points or (4096 if args.quick else fluid.wost_chunk)
    key = Key(0)
    pts, _ = sampling.fluid_points(key, N, scene, device=dev)
    grid = 0.1 * torch.ones((fluid.div_resolution,) * scene.dim,
                            dtype=torch.float32, device=dev)
    ws = fluid.walk_settings
    n_walks = args.n_walks or (16 if args.quick else None)
    if n_walks:
        ws = dataclasses.replace(ws, n_walks=n_walks)
    return fluid._wost_scene, ws, pts, key, (grid,)


def pool_trip(timer, wscene, ws, pts, key, src, res):
    """Items 1 and 2: the pool's trip and the advance step's parts at the
    pool's width, from S fresh start states."""
    from .ops import fastrand
    from .wost import pool as wp
    from .wost.solver import ACTIVE, _advance
    N, D = pts.shape
    dev = pts.device
    S = min(8 * N, 1 << 20)
    n_anti, n_pairs = 2, max(1, ws.n_walks // 2)
    W = n_pairs * n_anti * N
    K = max(1, ws.pool_refill_every)
    greens = wscene.greens()
    pd = wp._precompute(wscene, ws, pts, key)
    seed_w, seed2 = key.fold_in(1).stream_seed(), key.fold_in(2).stream_seed()
    g_ids = torch.arange(S, device=dev)

    def start():
        return wp._start_states(wscene, ws, pd, seed2, g_ids, src, n_pairs,
                                n_anti, N, None)
    st0, ok0, fs0, bv0, sv0 = start()
    w_, _, i_, _ = wp._decode(g_ids, n_anti, N)
    pl0 = w_ * N + i_

    def advance(settings, st=st0):
        return _advance(wscene, greens, settings, st,
                        wp._make_draw(seed_w, st, pl0), src,
                        step_cap=settings.pool_step_cap)
    st1 = advance(ws)
    carry1 = wp.PoolCarry(next_lane=S, st=st1, g=g_ids, ok=ok0,
                          first_src=fs0, bgd_vec=bv0, sgd_vec=sv0,
                          acc=torch.zeros((N, 3 + D), device=dev))
    cv = torch.zeros((N, 2), device=dev)

    def refill():
        return wp._scatter_refill(wscene, ws, pd, seed2, W, cv, carry1, src,
                                  n_pairs, n_anti, N, None)

    def trip():
        c, _ = refill()
        wa, _, ia, _ = wp._decode(c.g, n_anti, N)
        st = c.st
        for _ in range(K):
            st = _advance(wscene, greens, ws, st,
                          wp._make_draw(seed_w, st, wa * N + ia), src,
                          step_cap=ws.pool_step_cap)
        return st

    res["pool_width"] = {
        "start_states": timer(start),
        "advance": timer(lambda: advance(ws)),
        "advance_no_source": timer(lambda: advance(
            dataclasses.replace(ws, ignore_source=True))),
        "scatter_refill": timer(refill),
        "trip": timer(trip),
    }
    res["terminated_after_1_step"] = float(
        (st1.status != ACTIVE).float().mean())

    q = wscene.qmod()
    soup, x = wscene.neumann, st0.x
    far = torch.full(x.shape[:-1], 10.0, device=dev)
    d = torch.full_like(x, 0.7071)
    R0 = torch.full((S,), 0.5, device=dev)
    u2 = torch.stack([torch.full((S,), 0.3, device=dev),
                      torch.full((S,), 0.7, device=dev)], -1)

    def greens_bundle():
        ball = greens.make_ball(R0)
        r, ev = greens.sample_radius_u(ball, u2)
        return greens.dspk(ball, r) + greens.norm(ball) + ev

    def rng6():
        return [fastrand.uniform(seed_w, 3, salt, g_ids) for salt in range(6)]

    res["advance_parts"] = {
        "ray_intersect": timer(lambda: q.ray_intersect(
            soup, x, d, torch.ones(x.shape[:-1], device=dev))),
        "star_radius": timer(lambda: q.star_radius(
            soup, x, ws.min_star_radius, far)),
        "dirichlet_dist": timer(lambda: q.dist_to_far_bbox_corner(soup, x)),
        "greens_bundle": timer(greens_bundle),
        "rng6": timer(rng6),
        "source_lookup": timer(lambda: wscene.source_fn(x, *src)),
    }
    # rates of the advance step against the ceilings: the state's bytes
    # (read and written once a lane) over its device time
    adv = res["pool_width"]["advance"]
    state_bytes = sum(f.element_size() * f[0].numel() for f in st0)
    res["advance_per_lane_state_bytes_rw"] = 2 * state_bytes
    if adv["device_ms"] != NOT_MEASURED:
        rate = S / (adv["device_ms"] * 1e-3)
        res["advance_achieved"] = {
            "lane_steps_per_s_M": rate / 1e6,
            "state_GBs": rate * 2 * state_bytes / 1e9}
    return S, W


def end_to_end(wscene, ws, pts, key, src, dev, quick):
    """Item 4: the chunk on the pool and on gen: wall seconds (drained),
    walk steps, and the device's busy time over one profiled run (not
    with --quick)."""
    from .wost import gen, pool
    from .wost.solver import estimate_solution_and_gradient
    out = {}
    for algo, mod in (("pool", pool), ("gen", gen)):
        s = dataclasses.replace(ws, algo=algo)

        def run(s=s):
            return estimate_solution_and_gradient(wscene, s, pts, key,
                                                  source_args=src)
        run()                                       # warm
        mod.counts.update(dict.fromkeys(mod.counts, 0))
        walls = []
        for _ in range(1 if quick else 3):
            _sync(dev)
            t0 = time.perf_counter()
            run()
            _sync(dev)
            walls.append(time.perf_counter() - t0)
        reps = len(walls)
        counts = {k: v / reps for k, v in mod.counts.items()
                  if k in ("trips", "steps", "generations", "lane_steps")}
        busy_ms, kernels = (NOT_MEASURED, NOT_MEASURED) if quick \
            else device_busy(run, dev)
        wall = float(np.median(walls))
        row = {"wall_s": wall, "walls_s": walls, "counts": counts,
               "device_busy_s": (busy_ms / 1e3 if busy_ms != NOT_MEASURED
                                 else NOT_MEASURED),
               "kernels": kernels,
               "host_ms_per_walk_step": wall * 1e3 / counts["steps"]}
        if busy_ms != NOT_MEASURED:
            row["device_ms_per_walk_step"] = busy_ms / counts["steps"]
            row["device_idle_share"] = 1.0 - busy_ms / 1e3 / wall
            row["kernels_per_walk_step"] = kernels / counts["steps"]
        out[algo] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nmcfluid_torch."
                                 "tools_walk_roofline")
    ap.add_argument("--out", default="docs/walk_roofline_torch_r15.json")
    ap.add_argument("--scene", default="taylorgreen")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="4,096 points x 16 walks, 3 calls a measurement "
                         "and no profiler window, smaller ceilings, one "
                         "timed end-to-end run")
    ap.add_argument("--points", type=int, default=None,
                    help="the chunk's points (default: the fluid's chunk, "
                         "4,096 with --quick)")
    ap.add_argument("--n_walks", type=int, default=None,
                    help="walks a point (default: the scene's; 16 with "
                         "--quick)")
    ap.add_argument("--skip_e2e", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tools_walk_roofline: needs a CUDA device "
                         "(--device cpu rehearses it without times)")
    if dev.type != "cuda":
        args.quick = True
    res = {"card": card_line() if dev.type == "cuda" else NOT_MEASURED,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu (a rehearsal: no device number)"),
           "torch": torch.__version__, "scene": args.scene,
           "quick": args.quick}
    t_start = time.perf_counter()
    timer = Timer(dev, n=3 if args.quick else 8, profile=not args.quick)
    with torch.no_grad():
        wscene, ws, pts, key, src = _chunk(args, dev)
        S, W = pool_trip(timer, wscene, ws, pts, key, src, res)
        res["config"] = {"N_points": pts.shape[0], "S_slots": S,
                         "n_walks": ws.n_walks, "W_queued_walks": W,
                         "K_refill": ws.pool_refill_every,
                         "div_grid": list(src[0].shape)}
        res["ceilings"] = machine_ceilings(timer, dev, args.quick)
        if not args.skip_e2e:
            res["end_to_end"] = end_to_end(wscene, ws, pts, key, src, dev,
                                           args.quick)
    res["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
