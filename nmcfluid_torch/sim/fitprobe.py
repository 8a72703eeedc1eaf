"""Measure the fit kernel (csrc/fitkernel.cu) on the card.

    python -m nmcfluid_torch.sim.fitprobe [--shape tg] [--precision]

At one of the wrapper's shape families, on a K-batch pool made from a
numpy seed:

- times the kernel with sin and cos kept ("store", where they fit) and
  recomputed from a global stash ("recompute") with CUDA events, and
  splits one run of each into block 0's phases (sim/fitkernel.py::PHASES);
- --precision holds the kernel and the plain twin against the twin in
  float64 after 25 iterations: the largest error of each parameter tensor
  and how many elements leave the card tests' tolerance.

Every number needs a CUDA card; without one the probe exits with an error.
"""
import argparse

import numpy as np
import torch

from ..models.siren import SirenConfig, init_siren
from ..utils.keys import Key
from . import fitkernel as fk

# the wrapper's shape families (D_in, D_out, H, Lh, B) and the atol the
# card tests hold each to (rtol 2e-4)
SHAPES = {"tg": ((2, 2, 64, 6, 4096), 1e-3),
          "karman": ((2, 2, 128, 2, 16384), 2e-6),
          "smoke": ((3, 3, 64, 5, 16384), 1e-3),
          "karman3d": ((3, 3, 128, 2, 16384), 2e-6),
          "ragged": ((2, 2, 64, 2, 1000), 2e-6)}


def make_problem(dev, *, D_in=2, D_out=2, H=64, Lh=2, K=2, B=4096, seed=0,
                 dtype=torch.float32):
    """SIREN params from the port's initializer and a pool from numpy with
    the distributions of tests/test_fitkernel.py::make_problem."""
    cfg = SirenConfig(D_in, D_out, num_hidden_layers=Lh, hidden_features=H)
    params = [(W.to(dtype), b.to(dtype))
              for W, b in init_siren(Key(seed), cfg, dev)]
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    pool = (t(rng.uniform(-1.0, 1.0, (K, B, D_in))),
            t(rng.normal(size=(K, B, D_out, D_out)) * 0.5),
            t(rng.normal(size=(K, B, D_out)) * 0.1),
            t(rng.normal(size=(K, B, D_out)) * 0.2),
            t(rng.uniform(size=(K, B)) > 0.25))
    return cfg, params, pool


def time_fit(plan, params, pool):
    """(ms per iteration, {phase: us per iteration}): one warm-up call,
    one timed plan.n_iters fit (CUDA events), and one more split into
    block 0's phases."""
    fk.run_plan(plan._replace(n_iters=10), params, pool, 1e-5)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fk.run_plan(plan, params, pool, 1e-5)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / plan.n_iters
    ph = torch.zeros(len(fk.PHASES) + 2, dtype=torch.int64, device="cuda")
    fk.run_plan(plan, params, pool, 1e-5, phases=ph)
    ph = ph.tolist()
    ns_per_cycle = ph[-1] / ph[-2]
    return ms, {k: v * ns_per_cycle / plan.n_iters / 1e3
                for k, v in zip(fk.PHASES, ph)}


def precision(shape, dev):
    """{tensor: (|kernel - f64|, |twin - f64|, |kernel - twin|, elements
    outside rtol 2e-4 / atol)} after 25 iterations at lr 1e-3 on the card
    tests' pool (K = 2, seed 0)."""
    (D_in, D_out, H, Lh, B), atol = SHAPES[shape]
    dims = dict(D_in=D_in, D_out=D_out, H=H, Lh=Lh, B=B)
    cfg, params, pool = make_problem(dev, **dims)
    _, p64, pool64 = make_problem(dev, dtype=torch.float64, **dims)
    p_d, _ = fk.reference_adam_fit(p64, cfg, pool64, 25, 1e-3)
    p_r, _ = fk.reference_adam_fit(params, cfg, pool, 25, 1e-3)
    p_k, _ = fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)
    rows = {}
    for li, (k, r, d) in enumerate(zip(p_k, p_r, p_d)):
        for nm, a, b, c in (("W", k[0], r[0], d[0]), ("b", k[1], r[1], d[1])):
            diff = (a - b).abs()
            rows[f"{li}{nm}"] = (float((a.double() - c).abs().max()),
                                 float((b.double() - c).abs().max()),
                                 float(diff.max()),
                                 int((diff > atol + 2e-4 * b.abs()).sum()))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nmcfluid_torch.sim.fitprobe")
    ap.add_argument("--shape", choices=tuple(SHAPES), default="tg")
    ap.add_argument("--k", type=int, default=8, help="pool batches")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--precision", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fitprobe: needs a CUDA device")
    dev = torch.device("cuda")
    (D_in, D_out, H, Lh, B), _ = SHAPES[args.shape]
    cfg, params, pool = make_problem(dev, D_in=D_in, D_out=D_out, H=H,
                                     Lh=Lh, K=args.k, B=B)
    res = {"modes": {}, "precision": None}
    for name, recompute in (("store", False), ("recompute", True)):
        try:
            plan = fk.fit_plan(D_in, D_out, H, Lh, B, args.k, args.iters,
                               fk._sm_count(dev), recompute=recompute)
        except ValueError as e:       # sin and cos do not fit: no store
            print(f"{args.shape} {name}: {e}", flush=True)
            continue
        ms, ph = time_fit(plan, params, pool)
        res["modes"][name] = {"ms": ms, "phases_us": ph,
                              "n_wbuf": plan.n_wbuf}
        print(f"{args.shape} {name} ({plan.n_wbuf} weight buffers): "
              f"{ms * 1e3:.2f} us/iter; block 0: "
              + ", ".join(f"{k} {v:.2f}" for k, v in ph.items()), flush=True)
    if args.precision:
        res["precision"] = precision(args.shape, dev)
        for t, (ek, er, ekr, bad) in res["precision"].items():
            print(f"{args.shape} precision {t}: |kernel-f64| {ek:.3e} "
                  f"|twin-f64| {er:.3e} |kernel-twin| {ekr:.3e} outside "
                  f"tolerance {bad}", flush=True)
    return res


if __name__ == "__main__":
    main()
