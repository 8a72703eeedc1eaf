"""Gather probe: the rate of the walk's per-lane table gather, in four forms.

Counterpart of nmcfluid/wost/pallas_probe.py, and named after it so that the
two modules pair up by path as the rest of the port does; nothing here is
Pallas. On the TPU that module decided how the walk reads its tables: Mosaic
could not lower per-lane gathers, so the JAX walk draws radii through the
gather-free one-hot form. On the GPU the same question sets the design of a
per-lane walk kernel, which needs one gather per lane-step (the radius draw
in ops/radial_tables.py, the nearest-texel source in sim/sampling.py).

`gather_rows(table, idx, variant)` computes out[b] = table[idx[b]] for a
float32 (R, 4) table and int32 indices, n a multiple of BLOCK, in the four
forms the TPU tried, each a hand-written kernel in csrc/gather.cu:

  rows    one thread per row, one 16-byte load and store
  lanes   the gather along the lanes of the (4, R) transposed table,
          written (4, n) and returned transposed
  scalar  one thread per 1024-index block copying its rows serially
          (the worst case)
  onehot  the TPU's one-hot form on the (32512, 4) = (127, 256, 4) radial
          table: a one-hot product over the 128 padded Z rows, then the
          column 4 j0 + q of each quad (exact: one nonzero term). The
          kernel reads that column by address, so unlike the TPU body it
          is not gather-free.

On CUDA tensors it launches the kernel, or raises ValueError on what the
kernel does not take; on CPU tensors it runs `reference_gather_rows`, the
plain PyTorch version. The entry point runs every form and the PyTorch
baselines (torch.index_select, each plain version, and the walk's own draw
table_quads[i0, j0]), checks each against table[idx] and prints its
marginal time; --profile adds each form's device kernels:

    python -m nmcfluid_torch.wost.pallas_probe                 # on the card
    python -m nmcfluid_torch.wost.pallas_probe --table radial --n 524288
    python -m nmcfluid_torch.wost.pallas_probe --device cpu    # plain, untimed
"""
import argparse
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import get_device
from ..ops import radial_tables as rt
from ..utils import cuda_build

BLOCK = 1024                 # indices per TPU grid step
VARIANTS = ("rows", "lanes", "scalar", "onehot")
# the probe's baseline that runs each variant's plain version
PLAIN = {"rows": "torch_rows", "lanes": "torch_lanes",
         "scalar": "torch_rows", "onehot": "torch_onehot"}
ONEHOT_TABLE = (32512, 4)    # pack_quads(build_table(2)) as (R, 4) rows
_P = 4                       # floats per table row (one quad)
_SOURCES = ("gather.cu",)
_REPS = 50                   # launches per timed run, against 1
_SPIN_CYCLES = 20_000_000    # ~10 ms device spin ahead of a timed run

# kernel launches per variant (each gather_rows call on CUDA tensors
# launches one; a timed run of k repeats launches k)
launches = dict.fromkeys(VARIANTS, 0)


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load csrc/gather.cu."""
    lib = cuda_build.load("gather", _SOURCES)
    if not getattr(lib, "_nmc_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gather_run.argtypes = [I, P, P, P, I, I, I, P]
        lib.gather_run.restype = I
        lib._nmc_typed = True
    return lib


def _check_inputs(table, idx, variant):
    """The contract of both versions: raises ValueError where it breaks."""
    if variant not in VARIANTS:
        raise ValueError(f"gather_rows: unknown variant {variant!r}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: needs a float32 table and int32 "
                         f"indices, got {table.dtype} and {idx.dtype}")
    if table.dim() != 2 or table.shape[1] != _P or idx.dim() != 1:
        raise ValueError(f"gather_rows: needs an (R, {_P}) table and (n,) "
                         f"indices, got {tuple(table.shape)} and "
                         f"{tuple(idx.shape)}")
    if idx.shape[0] % BLOCK:
        raise ValueError(f"gather_rows: n = {idx.shape[0]} is not a "
                         f"multiple of {BLOCK}")
    if variant == "onehot" and tuple(table.shape) != ONEHOT_TABLE:
        raise ValueError(f"gather_rows: onehot needs the {ONEHOT_TABLE} "
                         f"radial table, got {tuple(table.shape)}")
    if table.device != idx.device:
        raise ValueError(f"gather_rows: table on {table.device}, indices "
                         f"on {idx.device}")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= table.shape[0]:
            raise ValueError(f"gather_rows: indices span [{lo}, {hi}], "
                             f"outside [0, {table.shape[0]})")


def _kernel_table(table, variant):
    """The table in the layout the variant's kernel reads (as the JAX
    wrapper's `tab`): (R, 4), its (4, R) transpose, or the onehot form
    padded by one zero Z row to (128, 1024)."""
    if variant == "lanes":
        return table.T.contiguous()
    if variant == "onehot":
        return F.pad(table.reshape(127, 1024), (0, 0, 0, 1)).contiguous()
    return table.contiguous()


def _empty_out(table, n, variant):
    shape = (_P, n) if variant == "lanes" else (n, _P)
    return torch.empty(shape, dtype=torch.float32, device=table.device)


def _launch(variant, tab, idx, out, R, reps=1):
    """`reps` kernel launches from one ctypes call, the r-th gathering rows
    (idx + r) % R into `out`."""
    lib = load_library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    with torch.cuda.device(idx.device):
        rc = lib.gather_run(VARIANTS.index(variant), ptr(tab), ptr(idx),
                            ptr(out), idx.shape[0], R, reps,
                            ctypes.c_void_p(stream))
    launches[variant] += reps
    if rc != 0:
        raise RuntimeError(f"gather kernel {variant!r} launch failed: CUDA "
                           f"error {rc}")


def gather_rows(table, idx, variant="rows"):
    """(R, 4) float32 table, (n,) int32 indices in [0, R) -> (n, 4) rows
    table[idx], through the variant's kernel on CUDA tensors and through
    `reference_gather_rows` on CPU tensors."""
    _check_inputs(table, idx, variant)
    if not table.is_cuda:
        return reference_gather_rows(table, idx, variant)
    idx = idx.contiguous()
    tab = _kernel_table(table, variant)
    if tab.data_ptr() % 16:
        raise ValueError("gather_rows: the table's rows must be 16-byte "
                         "aligned for the kernels' float4 loads")
    out = _empty_out(table, idx.shape[0], variant)
    _launch(variant, tab, idx, out, table.shape[0])
    return out.T if variant == "lanes" else out


def reference_gather_rows(table, idx, variant="rows"):
    """Plain PyTorch version of gather_rows, variant by variant."""
    i = idx.long()
    if variant == "lanes":
        return table.T[:, i].T
    if variant != "onehot":
        return table[i]
    # the JAX probe's xla_onehot: one-hot product, then masked lane sums
    tab = F.pad(table.reshape(127, 1024), (0, 0, 0, 1))
    i0 = torch.div(i, 256, rounding_mode="floor")
    j0 = i - i0 * 256
    hot = (torch.arange(128, device=idx.device) == i0[:, None]).float()
    row = torch.matmul(hot, tab)                        # (n, 1024)
    lane = torch.arange(1024, device=idx.device)
    return torch.stack([torch.sum(row * (lane == j0[:, None] * 4 + q), 1)
                        for q in range(4)], dim=1)


def marginal_ms(run, reps=_REPS, tries=3):
    """Marginal device time of one op in ms: (t_reps - t_1) / (reps - 1),
    each the least of `tries` CUDA-event timings of `run(k)`, which
    enqueues k ops. A device spin ahead of each timing lets the host
    enqueue all k before the first starts, so host dispatch and launch
    cost stay out of the number, as the JAX probe's fori_loop kept them."""
    def once(k):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(_SPIN_CYCLES)
        ev0.record()
        run(k)
        ev1.record()
        ev1.synchronize()
        return ev0.elapsed_time(ev1)
    run(1)                                              # warm-up
    t1 = min(once(1) for _ in range(tries))
    tk = min(once(reps) for _ in range(tries))
    return (tk - t1) / (reps - 1)


def walk_indices(Z, u):
    """int32 rows i0 * 256 + j0 of the flattened radial table, the quads
    that ops/radial_tables.py::sample_t_screened_u draws for Z and u."""
    zi = (torch.log(torch.clamp(Z, rt._Z_MIN, rt._Z_MAX))
          - rt._LOG_Z_MIN) / rt._DLOG
    i0 = torch.clamp(torch.floor(zi).to(torch.int64), 0, rt._N_Z - 2)
    j0 = torch.clamp(torch.floor(u * (rt._N_U - 1)).to(torch.int64), 0,
                     rt._N_U - 2)
    return (i0 * (rt._N_U - 1) + j0).to(torch.int32)


def probe_inputs(kind, n, device, rows=32512, seed=0):
    """The probe's table and indices from a numpy seed. "random": a normal
    (rows, 4) table and uniform rows, as the JAX probe's. "radial": the
    (32512, 4) radial table and the rows the walk's radius draw picks, for
    a Z log-uniform over the table's range and past both ends and a
    uniform u."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        table = rng.standard_normal((rows, _P)).astype(np.float32)
        idx = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32))
    else:
        table = rt.pack_quads(rt.build_table(2)).reshape(-1, _P).astype(
            np.float32)
        lz = rng.uniform(np.log(rt._Z_MIN) - 2, np.log(rt._Z_MAX) + 2, n)
        idx = walk_indices(torch.from_numpy(np.exp(lz).astype(np.float32)),
                           torch.from_numpy(rng.uniform(0, 1, n).astype(
                               np.float32)))
    return torch.from_numpy(table).to(device), idx.to(device)


def profile_kernels(run, k=3):
    """[(name, us per call)] of every entry with self device time in one
    torch.profiler window of k calls of `run`: the device kernels and
    copies, and the aten ops and profiler buffers that carry their time."""
    from torch.profiler import ProfilerActivity, profile
    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(k)
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            out.append((e.key, t / k))
    return out


def _err(got, want):
    if got.shape != want.shape:
        return float("inf")
    return float((got - want).abs().max()) if want.numel() else 0.0


def main(argv=None):
    """Run every form, check it against table[idx], and time it on the card.
    Returns {form: {"ok": bool, "ms": marginal ms/op or None, "err": max
    |form - table[idx]|}}."""
    ap = argparse.ArgumentParser(
        prog="python -m nmcfluid_torch.wost.pallas_probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu, "
                         "which runs the plain versions untimed")
    ap.add_argument("--table", choices=("random", "radial"), default="random",
                    help="a normal table with uniform rows, or the radial "
                         "table with the walk's radius-draw rows")
    ap.add_argument("--rows", type=int, default=32512,
                    help="rows of the random table")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--profile", action="store_true",
                    help="print each form's device kernels from one "
                         "torch.profiler window (cuda only)")
    args = ap.parse_args(argv)
    dev = get_device(args.device)
    timed = dev.type == "cuda"
    if args.profile and not timed:
        ap.error("--profile needs --device cuda")

    table, idx = probe_inputs(args.table, args.n, dev, args.rows)
    R = table.shape[0]
    want = reference_gather_rows(table, idx, "rows")
    onehot_ok = (R, _P) == ONEHOT_TABLE
    # the repeat k of a timed run gathers (idx + k) % R, as the JAX rep(k)
    shifted = [torch.remainder(idx + k, R) for k in range(_REPS)] \
        if timed else []

    def baseline(fn, prep=lambda i: i):
        args_k = [prep(i) for i in shifted]

        def run(k):
            for j in range(k):
                fn(args_k[j])
        return fn(prep(idx)), run, None

    def kernel(variant):
        tab = _kernel_table(table, variant)
        out = _empty_out(table, args.n, variant)

        def run(k):
            _launch(variant, tab, idx, out, R, reps=k)
        # after timing, `out` holds the last repeat's rows
        last = lambda: out.T if variant == "lanes" else out
        return gather_rows(table, idx, variant), run, last

    def quad_index(i):
        i = i.long()
        return torch.div(i, 256, rounding_mode="floor"), torch.remainder(
            i, 256)

    # PyTorch baselines: the library gather (the bar to beat), the plain
    # versions, and the walk's own draw table_quads[i0, j0]
    baselines = {
        "torch": (lambda i: torch.index_select(table, 0, i),),
        "torch_rows": (lambda i: reference_gather_rows(table, i, "rows"),),
        "torch_lanes": (lambda i: reference_gather_rows(table, i, "lanes"),),
        "torch_onehot": (lambda i: reference_gather_rows(table, i,
                                                         "onehot"),),
        "torch_quads": (lambda ij: table.view(127, 256, _P)[ij], quad_index)}
    results, profiles = {}, {}
    for form in tuple(baselines) + VARIANTS:
        if form in ("torch_onehot", "torch_quads", "onehot") \
                and not onehot_ok:
            print(f"{form:12s}: not run (needs --rows {ONEHOT_TABLE[0]})")
            continue
        if form in baselines:
            got, run, last = baseline(*baselines[form])
        elif timed:
            got, run, last = kernel(form)
        else:
            got, run, last = gather_rows(table, idx, form), None, None
        ok, err = torch.equal(got, want), _err(got, want)
        ms = marginal_ms(run) if timed else None
        if last is not None:
            want_last = table[shifted[-1].long()]
            ok = ok and torch.equal(last(), want_last)
            err = max(err, _err(last(), want_last))
        if args.profile:
            profiles[form] = profile_kernels(run)
        results[form] = {"ok": ok, "ms": ms, "err": err}
        line = f"{form:12s}: {'OK' if ok else 'WRONG-RESULT'}"
        if ms is None:
            line += f" ({dev.type}: plain version, not timed)"
        else:
            line += (f" marginal {ms:9.5f} ms/op for {args.n} x4 draws "
                     f"({args.n * 16 / max(ms * 1e-3, 1e-12) / 1e9:.1f} "
                     f"GB/s payload)")
        print(line, flush=True)
    for form, kernels in profiles.items():
        for name, us in kernels:
            print(f"profile {form:12s}: {us:10.3f} us/call  {name[:100]}")
    return results


if __name__ == "__main__":
    res = main()
    raise SystemExit(0 if all(r["ok"] for r in res.values()) else 1)
