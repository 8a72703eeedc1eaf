"""Measure the fit kernel (csrc/fitkernel.cu) on the card.

    python -m nmcfluid_torch.sim.fitprobe [--shape tg] [--precision]
    python -m nmcfluid_torch.sim.fitprobe --scene karman3d [--seeds 3] \\
        [--faults]
    python -m nmcfluid_torch.sim.fitprobe --key_sweep 12 [--out F.json]

At one of the wrapper's shape families, on a K-batch pool made from a
numpy seed:

- times the kernel with sin and cos kept ("store", where they fit) and
  recomputed from a global stash ("recompute") with CUDA events, and
  splits one run of each into block 0's phases (sim/fitkernel.py::PHASES);
- --precision holds the kernel and the plain twin against the twin in
  float64 after 25 iterations: the largest error of each parameter tensor
  and how many elements leave the card tests' tolerance.
- --scene NAME does the same on the pools chip_smoke.py checks the kernel
  on, built by the scene itself (its hard-BC (A, c) map and source), for
  --seeds pool seeds (no timing); with --faults it also reads what a
  faulty fit reads there: the twin with TF32 products, and copies of
  csrc/fitkernel.cu with one deliberate fault each (FAULTS; built
  together, with cuda_build's flags, into nmcfluid_torch/_build/), so
  that a tolerance can be seen to tell them from the kernel.
- --key_sweep N reads the fit checks of tests/test_torch_gpu.py and
  chip_smoke.py whose initial weights come from a key over keys 0..N-1:
  the kernel, the f32 twin and each of FAULTS against the twin and the
  float64 twin, and prints the share of each check's bounds the kernel
  takes at most and each fault at least (key_sweep); their bounds
  (SHAPES, CYCLING_ATOL, SCENE3D_ATOL, SMOKE_ATOL) are sized from it.

Every number needs a CUDA card; without one the probe exits with an error.
"""
import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models.siren import SirenConfig, init_siren
from ..utils import cuda_build
from ..utils.keys import Key
from . import fitkernel as fk

# the wrapper's shape families (D_in, D_out, H, Lh, B) and the atol the
# card tests hold each to (rtol 2e-4). Where a test's initial weights
# come from a key, its atol is 1.25 x the most the kernel read over keys
# 0-11 (key_sweep; rounded up at the second digit) where that passes the
# old atol: karman's 2e-6 and karman3d's 2e-6 were read over by the
# kernel at 3 and 1 of 12 keys.
SHAPES = {"tg": ((2, 2, 64, 6, 4096), 1e-3),
          "karman": ((2, 2, 128, 2, 16384), 5.3e-6),
          "smoke": ((3, 3, 64, 5, 16384), 1e-3),
          "karman3d": ((3, 3, 128, 2, 16384), 2.7e-6),
          "ragged": ((2, 2, 64, 2, 1000), 2e-6)}
# the same for the card tests' pool-cycling fit and their fits on the 3D
# scenes' own pools (one atol against the twin and the float64 twin)
CYCLING_ATOL = 4.2e-6
SCENE3D_ATOL = {"smoke": 1e-3, "karman3d": 3.1e-5}
# chip_smoke.py's fit check on the 2 x 128 nets: (atol against the twin,
# against the float64 twin), sized the same way
SMOKE_ATOL = {"karman": (1e-5, 1.8e-5), "jpipe": (1e-5, 2.4e-5),
              "karman3d": (1.2e-5, 2.3e-5)}


# name -> edits of csrc/fitkernel.cu, each found there once: faults of the
# size a precision slip or an indexing slip would leave
FAULTS = {
    # the hidden weight gradients from TF32 operands (10-bit mantissas),
    # as a TF32 tensor-core product would take them
    "tf32_wgrad": [
        ("constexpr float ADAM_EPS = 1e-8f;\n",
         "constexpr float ADAM_EPS = 1e-8f;\n"
         "__device__ __forceinline__ float tf32r(float x) {\n"
         "  return __uint_as_float((__float_as_uint(x) + 0x1000u) & "
         "0xffffe000u);\n}\n"),
        ("acc[a][b] = fmaf(sv[a], gv[b], acc[a][b]);",
         "acc[a][b] = fmaf(tf32r(sv[a]), tf32r(gv[b]), acc[a][b]);")],
    # the gradient sum leaves out the last block's partial row
    "drop_row": [
        ("const int r1 = min((grp + 1) * rpg, p.n_work);",
         "const int r1 = min((grp + 1) * rpg, p.n_work - 1);")],
    # sin and cos by the fast intrinsics (what --use_fast_math would do)
    "fast_sincos": [
        ("  sincosf(OMEGA * z, &s, &c);", "  __sincosf(OMEGA * z, &s, &c);"),
        ("  sincosf(OMEGA * a.C(l)[idx], &s, &c);",
         "  __sincosf(OMEGA * a.C(l)[idx], &s, &c);"),
        ("sincosf(OMEGA * cz, &sz, &cz);",
         "__sincosf(OMEGA * cz, &sz, &cz);")],
}


def fault_source(name):
    """csrc/fitkernel.cu with the fault's edits."""
    with open(os.path.join(cuda_build.CSRC, fk._SOURCES[0])) as f:
        src = f.read()
    for old, new in FAULTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"fitprobe: {old!r} is not in "
                               f"csrc/fitkernel.cu once")
        src = src.replace(old, new)
    return src


def fault_libraries():
    """{fault: typed library}, every copy built at once."""
    with ThreadPoolExecutor(len(FAULTS)) as ex:
        libs = {n: ex.submit(cuda_build.load_source, f"fitkernel_{n}",
                             fault_source(n)) for n in FAULTS}
        return {n: fk.typed(f.result()) for n, f in libs.items()}


def make_problem(dev, *, D_in=2, D_out=2, H=64, Lh=2, K=2, B=4096, seed=0,
                 dtype=torch.float32, key_seed=None):
    """SIREN params from the port's initializer (Key(key_seed), default
    Key(seed)) and a pool from numpy's seed with the distributions of
    tests/test_fitkernel.py::make_problem."""
    cfg = SirenConfig(D_in, D_out, num_hidden_layers=Lh, hidden_features=H)
    key = Key(seed if key_seed is None else key_seed)
    params = [(W.to(dtype), b.to(dtype))
              for W, b in init_siren(key, cfg, dev)]
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    pool = (t(rng.uniform(-1.0, 1.0, (K, B, D_in))),
            t(rng.normal(size=(K, B, D_out, D_out)) * 0.5),
            t(rng.normal(size=(K, B, D_out)) * 0.1),
            t(rng.normal(size=(K, B, D_out)) * 0.2),
            t(rng.uniform(size=(K, B)) > 0.25))
    return cfg, params, pool


def scene_pool(fluid, K, seed):
    """A pool of a scene's shapes from a numpy seed: points in the box,
    the scene's affine hard-BC map at its ramp width, the initial velocity
    (smoke's jitter from a key of the seed) plus noise as target, weight 1
    in the fluid and 0 inside obstacles."""
    dev = fluid.device
    rng = np.random.default_rng(seed)
    B, D = fluid.n_batch, fluid.scene.dim
    ss = fluid.scene.scene_size
    x = rng.uniform(ss[0::2], ss[1::2], (K, B, D))
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    A, c = fluid.velocity_affine(x, eps=fluid.scene.bdry_eps, t=0)
    noise = torch.from_numpy(
        rng.normal(0.0, 0.05, (K, B, D)).astype(np.float32)).to(dev)
    tgt = fluid.scene.source_velocity(x, key=Key(seed)) + noise
    return (x, A.contiguous(), c.contiguous(), tgt,
            fluid.scene.fluid_mask(x).to(torch.float32))


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


def scene_precision(name, dev, seeds, faults=False):
    """{seed: {fit: (max |fit - twin|, max |fit - f64|, elements of fit
    outside rtol 2e-4 / the family's atol of the f64 twin)}} after 25
    iterations at lr 1e-3 on scene_pool(K = 8, seed), from the weights
    chip_smoke.py starts from (init_state(1)). The fits: the kernel and the
    f32 twin; with `faults`, the twin with TF32 products and each of
    FAULTS."""
    from ..scenes import get_scene
    from .fluid import NeuralFluid
    fluid = NeuralFluid(get_scene(name), device=dev)
    family = {"taylorgreen": "tg", "smoke_obs": "smoke",
              "vortex_collide": "smoke", "jpipe": "karman"}.get(name, name)
    atol = SHAPES[family][1]
    cfg, params = fluid.siren_cfg, fluid.init_state(1).params
    p64 = [(W.double(), b.double()) for W, b in params]
    libs = fault_libraries() if faults else {}
    out = {}
    for seed in range(seeds):
        pool = scene_pool(fluid, 8, seed)
        K, B, D_in, D_out, H, Lh = fk._shapes(params, pool)
        plan = fk.fit_plan(D_in, D_out, H, Lh, B, K, 25, fk._sm_count(dev))
        fits = {"kernel": fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)[0],
                "twin": fk.reference_adam_fit(params, cfg, pool, 25,
                                              1e-3)[0]}
        if faults:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                fits["twin_tf32"] = fk.reference_adam_fit(
                    params, cfg, pool, 25, 1e-3)[0]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            for n, lib in libs.items():
                fits[n] = fk.run_plan(plan, params, pool, 1e-3, lib=lib)[0]
        p_d, _ = fk.reference_adam_fit(
            p64, cfg, tuple(t.double() for t in pool), 25, 1e-3)
        flat = {k: [t.double() for pair in p for t in pair]
                for k, p in fits.items()}
        ref = [t for pair in p_d for t in pair]
        row = {}
        for k, ts in flat.items():
            et = max(float((a - r).abs().max())
                     for a, r in zip(ts, flat["twin"]))
            ed = max(float((a - d).abs().max()) for a, d in zip(ts, ref))
            bad = sum(int(((a - d).abs() > atol + 2e-4 * d.abs()).sum())
                      for a, d in zip(ts, ref))
            row[k] = (et, ed, bad)
        out[seed] = row
    return out


def _excess(fit, ref):
    """How far `fit` leaves `ref` (lists of tensors) at rtol 2e-4: the 4
    largest |fit - ref| - 2e-4 |ref| (the atol each element needs, largest
    first), the largest |fit - ref| and its RMS."""
    a = torch.cat([t.double().reshape(-1) for t in fit])
    b = torch.cat([t.double().reshape(-1) for t in ref])
    d = (a - b).abs()
    top = torch.topk(d - 2e-4 * b.abs(), 4).values
    return {"top": [float(v) for v in top], "max_abs": float(d.max()),
            "rms": float(torch.sqrt(torch.mean(d * d)))}


def _sweep_problems(dev):
    """{check: ((atol, float64 atol or None), make(k) -> (cfg, params,
    pool, n_iters, lr))}: the fit checks of tests/test_torch_gpu.py and
    chip_smoke.py whose initial weights come from a key, with that key
    shifted by k (their pools do not change with k)."""
    from ..scenes import get_scene
    from .fluid import NeuralFluid
    out = {}
    for i, fam in enumerate(("tg", "karman", "smoke", "karman3d", "ragged")):
        (D_in, D_out, H, Lh, B), atol = SHAPES[fam]

        def make(k, dims=dict(D_in=D_in, D_out=D_out, H=H, Lh=Lh, B=B)):
            cfg, params, pool = make_problem(dev, key_seed=k, **dims)
            return cfg, params, pool, 25, 1e-3
        out[f"test_kernel_matches_twin_on_card[shape{i}]"] = ((atol, None),
                                                              make)

    def cycling(k):
        cfg, params, pool = make_problem(dev, K=2, B=2048, seed=3,
                                         key_seed=3 + k)
        x, A, c, tgt, w = pool
        w = w.clone()
        w[1] = 0.0
        lr = 1e-3 * 0.85 ** torch.arange(12, dtype=torch.float32)
        return cfg, params, (x, A, c, tgt, w), 12, lr
    out["test_pool_cycling_and_lr_array_on_card"] = ((CYCLING_ATOL, None),
                                                      cycling)
    fluids = {n: NeuralFluid(get_scene(n), device=dev)
              for n in ("smoke", "karman", "jpipe", "karman3d")}
    for name, atol in SCENE3D_ATOL.items():
        fluid = fluids[name]
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.uniform(-1.0, 1.0, (4, fluid.n_batch, 3))
                             .astype(np.float32)).to(dev)
        A, c = fluid.velocity_affine(x, eps=fluid.scene.bdry_eps, t=0)
        pool = (x, A.contiguous(), c.contiguous(),
                fluid.scene.source_velocity(x, key=Key(5)),
                fluid.scene.fluid_mask(x).to(torch.float32))

        def scene3d(k, fluid=fluid, pool=pool):
            return (fluid.siren_cfg, fluid.init_state(2 + k).params, pool,
                    25, 1e-3)
        out[f"test_3d_scene_pool_kernel_matches_twin_on_card[{name}]"] = (
            (atol, atol), scene3d)
    for name in ("karman", "jpipe", "karman3d"):
        fluid = fluids[name]
        for seed in range(3):
            pool = scene_pool(fluid, 8, seed)

            def smoke_fit(k, fluid=fluid, pool=pool):
                return (fluid.siren_cfg, fluid.init_state(1 + k).params,
                        pool, 25, 1e-3)
            out[f"chip_smoke.py {name} pool seed {seed}"] = (
                SMOKE_ATOL[name], smoke_fit)
    return out


def key_sweep(dev, keys, faults=True):
    """{check: {"atol": (atol, float64 atol or None), "keys": {k: {fit:
    {"twin": _excess against the f32 twin, "f64": _excess against the
    float64 twin, "loss": the last loss's relative distance from the
    twin's}}}}} for the checks of _sweep_problems, with their key shifted
    by each k of `keys`. The fits: the f32 twin ("twin", against float64
    only), the kernel, and with `faults` each copy of FAULTS. Prints, for
    each check (chip_smoke.py's over its three pool seeds), the largest
    share of its bounds the kernel takes over the keys, and for each fault
    the least share and at how many keys the check fails it."""
    libs = fault_libraries() if faults else {}
    out = {}
    for check, (atol, make) in _sweep_problems(dev).items():
        rows = {}
        for k in keys:
            cfg, params, pool, n, lr = make(k)
            p_r, l_r = fk.reference_adam_fit(params, cfg, pool, n, lr)
            p_d, _ = fk.reference_adam_fit(
                [(W.double(), b.double()) for W, b in params], cfg,
                tuple(t.double() for t in pool), n, lr)
            flat = lambda p: [t for pair in p for t in pair]
            twin, ref = flat(p_r), flat(p_d)
            K, B, D_in, D_out, H, Lh = fk._shapes(params, pool)
            plan = fk.fit_plan(D_in, D_out, H, Lh, B, K, n, fk._sm_count(dev))
            fits = {"kernel": fk.run_plan(plan, params, pool, lr)}
            for name, lib in libs.items():
                fits[name] = fk.run_plan(plan, params, pool, lr, lib=lib)
            row = {"twin": {"f64": _excess(twin, ref)}}
            for name, (p, loss) in fits.items():
                row[name] = {"twin": _excess(flat(p), twin),
                             "f64": _excess(flat(p), ref),
                             "loss": abs(float(loss) - float(l_r))
                             / max(abs(float(l_r)), 1e-30)}
            rows[k] = row
        out[check] = {"atol": atol, "keys": rows}
    for group, runs in sweep_shares(out).items():
        print(f"{group}: " + "; ".join(
            f"{fit} {'most' if fit == 'kernel' else 'least'} share "
            f"{min(sh) if fit != 'kernel' else max(sh):.2f}"
            + ("" if fit == "kernel"
               else f", failed at {sum(s > 1.0 for s in sh)}/{len(sh)} keys")
            for fit, sh in runs.items()), flush=True)
    return out


def sweep_shares(res):
    """{check: {fit: [the share of its bounds the fit takes, a key]}} from
    key_sweep's result, chip_smoke.py's pool seeds as one check (the
    largest share over them): the atol each element needs against the
    twin, and against the float64 twin where the check holds one, over
    the check's atol."""
    out = {}
    for check, v in res.items():
        group = check.split(" pool seed")[0]
        bt, bd = v["atol"]
        for k, row in v["keys"].items():
            for fit, r in row.items():
                if fit == "twin":
                    continue
                share = r["twin"]["top"][0] / bt
                if bd is not None:
                    share = max(share, r["f64"]["top"][0] / bd)
                sh = out.setdefault(group, {}).setdefault(fit, {})
                sh[k] = max(sh.get(k, 0.0), share)
    return {g: {f: list(sh.values()) for f, sh in fits.items()}
            for g, fits in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nmcfluid_torch.sim.fitprobe")
    ap.add_argument("--shape", choices=tuple(SHAPES), default="tg")
    ap.add_argument("--k", type=int, default=8, help="pool batches")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--precision", action="store_true")
    ap.add_argument("--scene", default=None,
                    help="precision on this scene's own pools instead")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--faults", action="store_true",
                    help="with --scene: also the TF32 twin and FAULTS")
    ap.add_argument("--key_sweep", type=int, default=0,
                    help="the keyed fit checks over keys 0..N-1, with "
                         "FAULTS")
    ap.add_argument("--out", default=None, help="--key_sweep's JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fitprobe: needs a CUDA device")
    dev = torch.device("cuda")
    if args.key_sweep:
        res = key_sweep(dev, list(range(args.key_sweep)))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=0, sort_keys=True)
        return res
    if args.scene:
        res = scene_precision(args.scene, dev, args.seeds, args.faults)
        for seed, row in res.items():
            for fit, (et, ed, bad) in row.items():
                print(f"{args.scene} pool seed {seed} {fit}: max |fit-twin| "
                      f"{et:.3e}, |fit-f64| {ed:.3e}; elements outside "
                      f"the family's tolerance of f64 {bad}", flush=True)
        return res
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
