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
  scalar  the TPU's loop of scalar slices over each 1024-index block, run
          by a block of 256 threads: indices staged in shared memory, then
          16 unrolled 4-byte loads a thread before its 16 stores
  onehot  the TPU's one-hot form on the (32512, 4) = (127, 256, 4) radial
          table, on the tensor cores: a block takes a chunk of lanes and a
          range of quad columns j0 = i % 256, sorts the chunk's lanes in
          its range by j0, and each 16-lane tile multiplies the one-hot of
          its Z rows i0 = i / 256 by the bytes of column j0 (u8 mma, s32
          sums with one nonzero term), so it is exact for every bit
          pattern. Its launch plan is `onehot_plan`; its table is the
          padded table relaid once in B-fragment order (`_kernel_table`).

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
import functools
from typing import NamedTuple

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
# the onehot kernel's constants (csrc/gather.cu)
ONEHOT_L_MAX = 16384                       # lanes a chunk, most
ONEHOT_RANGES = (4, 8, 16)                 # quad-column ranges a chunk
ONEHOT_J = 256                             # quad columns
SMEM_MAX = 232_448                         # a block's shared memory, H100

# kernel launches per variant (each gather_rows call on CUDA tensors
# launches one; a timed run of k repeats launches k)
launches = dict.fromkeys(VARIANTS, 0)


class OnehotPlan(NamedTuple):
    """Launch plan of gather_onehot_k: `chunks` x `ranges` blocks of 512
    threads. Block (c, r) takes the lanes [c * lanes,
    min((c + 1) * lanes, n)) whose quad column j0 lies in [r * J, (r + 1)
    * J), J = 256 / ranges, with `smem_bytes` of dynamic shared memory."""
    n: int
    lanes: int
    ranges: int
    chunks: int
    ctas: int
    smem_bytes: int


def onehot_smem(lanes, ranges):
    """Dynamic shared memory of a onehot block (csrc/gather.cu::onehot_smem):
    4 bytes a lane of rows and 4 of sort keys, J + 1 bucket starts and J
    counts."""
    return 8 * lanes + (2 * (ONEHOT_J // ranges) + 1) * 4


def onehot_plan(n, n_sm, lanes=None, ranges=None):
    """The onehot launch plan for n lanes (a multiple of BLOCK) on a card
    with n_sm SMs. Each block scans every lane of its chunk and multiplies
    the ones of its 256 / ranges columns, so more ranges rescan each lane
    more often, and a chunk of 8192 lanes gives a column 32 lanes, one full
    pair of tiles on average. The plan takes chunks of 8192 lanes and 4
    ranges; while that makes fewer than n_sm / 2 blocks, it halves the
    chunk down to 4096 lanes, then doubles the ranges up to 16 (the best
    of the chunk and range sweep on the H100 at n = 65,536 and 524,288,
    PERF.md). `lanes` (a multiple of BLOCK in [BLOCK, ONEHOT_L_MAX]) and
    `ranges` (one of ONEHOT_RANGES) force the choice."""
    if n % BLOCK or n_sm < 1:
        raise ValueError(f"onehot plan: n = {n}, n_sm = {n_sm}")
    if lanes is not None and (lanes % BLOCK
                              or not BLOCK <= lanes <= ONEHOT_L_MAX):
        raise ValueError(f"onehot plan: lanes = {lanes}")
    if ranges is not None and ranges not in ONEHOT_RANGES:
        raise ValueError(f"onehot plan: ranges = {ranges}")
    steps = [(Lc, nr) for Lc, nr in ((8192, 4), (4096, 4), (4096, 8),
                                     (4096, 16))
             if lanes in (None, Lc) and ranges in (None, nr)] \
        or [(lanes or 8192, ranges or 4)]
    for Lc, nr in steps:
        chunks = -(-n // Lc)
        if 2 * chunks * nr >= n_sm:
            break
    return OnehotPlan(n, Lc, nr, chunks, chunks * nr, onehot_smem(Lc, nr))


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load csrc/gather.cu."""
    lib = cuda_build.load("gather", _SOURCES)
    if not getattr(lib, "_nmc_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gather_run.argtypes = [I, P, P, P, I, I, I, I, I, P]
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


def onehot_columns(table):
    """The (32512, 4) table padded by one zero Z row to (128, 1024), as the
    JAX wrapper's `tab`, and relaid j0-major: (256, 128, 4), whose element
    (j0, z, q) is the padded element (z, 4 j0 + q), so that one quad
    column is 2 KB contiguous."""
    pad = F.pad(table.reshape(127, 1024), (0, 0, 0, 1))
    return pad.reshape(128, ONEHOT_J, _P).transpose(0, 1).contiguous()


def onehot_fragments(columns):
    """The (256, 128, 4) columns in the order gather_onehot_k reads them:
    int32 words (256 j0, 4 s, 32 lanes, 4 c), c = 2 h + half. Byte e of the
    word of lane 4 g + t is byte 4 (g // 2) + 2 h + g % 2 of the quad on Z
    row 32 s + 16 half + 4 t + e: the u8 B fragment (k row 16 half + 4 t +
    e, column g) of mma.m16n8k32 for k-step s and n8 half h, with the
    quad's bytes ordered so that lane (g, t) of the product holds bytes 4 t
    .. 4 t + 3, float t, of its rows."""
    b = columns.contiguous().view(torch.uint8).reshape(ONEHOT_J, 4, 2, 4, 4,
                                                       4, 2, 2)
    # (j0, s, half, t, e, g // 2, h, g % 2) -> (j0, s, g, t, h, half, e)
    return b.permute(0, 1, 5, 7, 3, 6, 2, 4).contiguous().view(
        torch.int32).reshape(ONEHOT_J, 4, 32, 4)


def _kernel_table(table, variant):
    """The table in the layout the variant's kernel reads (as the JAX
    wrapper's `tab`): (R, 4), its (4, R) transpose, or the onehot form
    padded to 128 Z rows, j0-major, in B-fragment order. The relayouts are
    made once per table, outside a timed run's repeats."""
    if variant == "lanes":
        return table.T.contiguous()
    if variant == "onehot":
        return onehot_fragments(onehot_columns(table))
    return table.contiguous()


def _empty_out(table, n, variant):
    shape = (_P, n) if variant == "lanes" else (n, _P)
    return torch.empty(shape, dtype=torch.float32, device=table.device)


def _launch(variant, tab, idx, out, R, reps=1, lanes=None, ranges=None):
    """`reps` kernel launches from one ctypes call, the r-th gathering rows
    (idx + r) % R into `out`; onehot runs `onehot_plan` (`lanes` and
    `ranges` force its chunk and its column ranges)."""
    lib = load_library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    n = idx.shape[0]
    if variant == "onehot":
        plan = onehot_plan(n, _sm_count(idx.device), lanes, ranges)
        lanes, ranges = plan.lanes, plan.ranges
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    with torch.cuda.device(idx.device):
        rc = lib.gather_run(VARIANTS.index(variant), ptr(tab), ptr(idx),
                            ptr(out), n, R, reps, lanes or 0, ranges or 0,
                            ctypes.c_void_p(stream))
    launches[variant] += reps
    if rc != 0:
        raise RuntimeError(f"gather kernel {variant!r} launch failed: CUDA "
                           f"error {rc}")


def gather_rows(table, idx, variant="rows"):
    """(R, 4) float32 table, (n,) int32 indices in [0, R) -> (n, 4) rows
    table[idx], through the variant's kernel on CUDA tensors and through
    `reference_gather_rows` on CPU tensors. Every form moves the table's
    bits unchanged, whatever their value (onehot's sums are of bytes)."""
    _check_inputs(table, idx, variant)
    if not table.is_cuda:
        return reference_gather_rows(table, idx, variant)
    idx = idx.contiguous()
    tab = _kernel_table(table, variant)
    if tab.data_ptr() % 16:
        raise ValueError("gather_rows: the table's rows must be 16-byte "
                         "aligned")
    if variant in ("scalar", "onehot") and idx.data_ptr() % 16:
        raise ValueError(f"gather_rows: {variant} loads its indices 16 "
                         f"bytes at a time, so they must be 16-byte aligned")
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
    ap.add_argument("--onehot-lanes", type=int, default=None,
                    help="lanes of a onehot chunk in the timed runs (a "
                         "multiple of 1024 up to 16384; default: "
                         "onehot_plan's choice)")
    ap.add_argument("--onehot-ranges", type=int, default=None,
                    choices=ONEHOT_RANGES,
                    help="quad-column ranges of a onehot chunk in the "
                         "timed runs (default: onehot_plan's choice)")
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
            _launch(variant, tab, idx, out, R, reps=k,
                    lanes=args.onehot_lanes, ranges=args.onehot_ranges)
        # after timing, `out` holds the last repeat's rows
        last = lambda: out.T if variant == "lanes" else out
        return gather_rows(table, idx, variant), run, last

    def quad_index(i):
        i = i.long()
        return torch.div(i, 256, rounding_mode="floor"), torch.remainder(
            i, 256)

    # PyTorch baselines: the library gather, the plain versions (table[idx]
    # and table.T[:, idx].T are one-call forms of the same function too; the
    # fastest of the three is the bar to beat), and the walk's own draw
    # table_quads[i0, j0], which needs (i0, j0) made first
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
