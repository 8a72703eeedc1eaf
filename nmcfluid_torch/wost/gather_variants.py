"""What bounds the rows and lanes gathers on the card.

Builds copies of csrc/gather.cu in which one part of gather_rows_k or
gather_lanes_k is cut (VARIANTS; all nvcc started together, with
cuda_build's flags, into nmcfluid_torch/_build/), and times each at its
form's launch beside the kernel itself and the copy yardstick, with the
probe's marginal_ms on the random table. The kernel itself is held bit for
bit to table[(idx + 49) % R] after its timing; a cut copy (its rows are
wrong) is not. --sweep times the lanes kernel at every plan of the sweep
that lanes_plan was chosen from.

    python -m nmcfluid_torch.wost.gather_variants            # card only
    python -m nmcfluid_torch.wost.gather_variants --n 524288 --sweep \\
        --variant stage_only --variant no_stage
"""
import argparse
import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import get_device
from ..utils import cuda_build
from . import pallas_probe as pp

# name -> (the form it cuts, its edits of csrc/gather.cu, each found there
# once)
VARIANTS = {
    # rows: indices and stores only; table loads and no store
    "rows_no_load": ("rows", [
        ("for (int k = 0; k < ROWS_G; ++k) v[k] = __ldg(table + i[k]);",
         "for (int k = 0; k < ROWS_G; ++k) v[k] = "
         "make_float4(__int_as_float(i[k]), 0.f, 0.f, 0.f);")]),
    "rows_no_store": ("rows", [
        ("if (b0 + k * ROWS_NT < n) out[b0 + k * ROWS_NT] = v[k];",
         "if (b0 + k * ROWS_NT < n && v[k].x == 1.2345e-38f && "
         "v[k].y == v[k].w) out[b0 + k * ROWS_NT] = v[k];")]),
    # lanes: the row's staging and nothing else; everything but it
    "stage_only": ("lanes", [
        ("    if (b < n)\n      *reinterpret_cast",
         "    if (b < n && n < 0)\n      *reinterpret_cast")]),
    "no_stage": ("lanes", [
        ("const int nv = lanes_pitch(R) / 4;",
         "const int nv = 0 * lanes_pitch(R);")]),
}
# the sweep of (per_thread, threads) lanes_plan was chosen from
SWEEP = [(g, t) for g in pp.LANES_PER_THREAD for t in (256, 512, 1024)]


def variant_source(name):
    """csrc/gather.cu with the variant's edits."""
    with open(os.path.join(cuda_build.CSRC, "gather.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name][1] if name else []:
        if src.count(old) != 1:
            raise RuntimeError(f"gather_variants: {old!r} is not in "
                               f"csrc/gather.cu once")
        src = src.replace(old, new)
    return src


def _load(name):
    lib = cuda_build.load_source(f"gather_{name or 'kernel'}",
                                 variant_source(name))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gather_run.argtypes = [I, P, P, P, I, I, I, I, I, P]
    lib.gather_run.restype = I
    return name, lib


def time_form(lib, form, table, idx, plan, exact):
    """Marginal ms of one gather of `form` at `plan` from `lib`, and, if
    `exact`, whether the last repeat equals table[(idx + reps - 1) % R]
    bit for bit (else None)."""
    R, n = table.shape[0], idx.shape[0]
    tab = pp._kernel_table(table, form)
    out = pp._empty_out(table, n, form)
    code, a, b = pp.run_args(form, plan)
    stream = torch.cuda.current_stream(idx.device).cuda_stream

    def run(k):
        rc = lib.gather_run(code, tab.data_ptr(), idx.data_ptr(),
                            out.data_ptr(), n, R, k, a, b,
                            ctypes.c_void_p(stream))
        if rc:
            raise RuntimeError(f"gather_variants: CUDA error {rc}")
    ms = pp.marginal_ms(run)
    if not exact:
        return ms, None
    got = out.T if form == "lanes" else out
    want = table[(idx.long() + pp._REPS - 1) % R]
    return ms, torch.equal(got.view(torch.int32), want.view(torch.int32))


def main(argv=None):
    """Time the kernels, their cut copies and (--sweep) the lanes plans;
    returns a list of {"form", "variant", "n", "plan", "ms", "exact"}."""
    ap = argparse.ArgumentParser(
        prog="python -m nmcfluid_torch.wost.gather_variants")
    ap.add_argument("--n", type=int, action="append", default=None,
                    help="lanes; repeatable (default 65536 and 524288)")
    ap.add_argument("--variant", action="append", default=None,
                    choices=tuple(VARIANTS),
                    help="repeatable (default: every variant)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the lanes kernel at every plan of the "
                         "sweep")
    args = ap.parse_args(argv)
    dev = get_device("cuda")
    names = args.variant or list(VARIANTS)
    with ThreadPoolExecutor() as ex:
        libs = dict(ex.map(_load, [None] + names))
    n_sm = pp._sm_count(dev)
    results = []

    def record(form, name, n, plan, ms, exact):
        results.append({"form": form, "variant": name or "kernel", "n": n,
                        "plan": plan._asdict() if plan else None, "ms": ms,
                        "exact": exact})
        print(f"{form:5s} {name or 'kernel':13s} n {n:7d} "
              f"{plan or 'fixed launch'}: {ms:.5f} ms, exact {exact}",
              flush=True)
        if exact is False:
            raise AssertionError(f"{form} {name}: wrong rows")

    for n in args.n or (65536, 524288):
        table, idx = pp.probe_inputs("random", n, dev)
        R = table.shape[0]
        print(f"copy yardstick n {n}: "
              f"{pp.copy_yardstick(n, dev)['ms']:.5f} ms", flush=True)
        for form in ("rows", "lanes"):
            plan = pp.plan_for(form, n, R, n_sm)
            record(form, None, n, plan,
                   *time_form(libs[None], form, table, idx, plan, True))
            for name in names:
                if VARIANTS[name][0] == form:
                    record(form, name, n, plan,
                           *time_form(libs[name], form, table, idx, plan,
                                      False))
        if args.sweep:
            for p in SWEEP:
                plan = pp.lanes_plan(n, R, n_sm, *p)
                record("lanes", None, n, plan, *time_form(
                    libs[None], "lanes", table, idx, plan, True))
    return results


if __name__ == "__main__":
    main()
