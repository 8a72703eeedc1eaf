"""Where gather_onehot_k's time goes, phase by phase, on the card.

Builds a copy of csrc/gather.cu in which thread 0 of every block stamps
clock64() after each phase (the sort's rows and histogram, the scan, the
key scatter, the tiles, each ended by a block barrier) and the globaltimer
at its start and end, runs it at a plan, checks its rows against
table[(idx + 19) % R] and prints each phase's cycles a block (mean and
largest) and the span from the first block's start to the last one's end.
Two variants cut a part of the tile phase to show its cost (their rows are
wrong and not checked): "one_kstep" runs 2 of a tile's 8 mma.sync,
"no_store" stores no row.

    python -m nmcfluid_torch.wost.gather_phases              # card only
    python -m nmcfluid_torch.wost.gather_phases --variant no_store \\
        --plan 524288,8192,4

The copy is built with cuda_build's flags into nmcfluid_torch/_build/.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from .. import get_device
from ..utils import cuda_build
from . import pallas_probe as pp

_STAMP = ("if (threadIdx.x == 0) {{ st[{k}] = clock64(); }}\n")
_TIMER = ("if (threadIdx.x == 0) {{ unsigned long long gt; asm volatile("
          "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt)); st[{k}] = gt; }}\n")
# text of csrc/gather.cu -> its stamped copy; each must be found once
_EDITS = [
    ("                int Lc) {\n",
     "                int Lc, long long* stamps) {\n"
     "  long long* st = stamps + blockIdx.x * 8;\n"
     + _STAMP.format(k=0) + _TIMER.format(k=6)),
    ("  // 2. exclusive scan", _STAMP.format(k=1) + "  // 2. exclusive scan"),
    ("  // 3. the owned lanes", _STAMP.format(k=2) + "  // 3. the owned lanes"),
    ("  // 4. the products", _STAMP.format(k=3) + "  // 4. the products"),
    ("      onehot_pair(fb, s_key, o, p, end, g, t);\n  }\n}\n",
     "      onehot_pair(fb, s_key, o, p, end, g, t);\n  }\n  __syncthreads();\n"
     + _STAMP.format(k=4) + _TIMER.format(k=7) + "}\n"),
    ("n, R, off, Lc);", "n, R, off, Lc, g_stamps);"),
    ("template <int NB>\nint onehot_run(",
     "long long* g_stamps = nullptr;\ntemplate <int NB>\nint onehot_run("),
    ('extern "C" {\n',
     'extern "C" {\nvoid set_stamps(long long* p) { g_stamps = p; }\n'),
]
VARIANTS = {
    "one_kstep": [("  for (int s = 0; s < 4; ++s) {\n    const uint4 b",
                   "  for (int s = 0; s < 1; ++s) {\n    const uint4 b")],
    "no_store": [("    if (p + g + 8 * r < end)\n      out[",
                  "    if (p + g + 8 * r < end && end < 0)\n      out[")],
}


def stamped_source(variant=None):
    src = open(os.path.join(cuda_build.CSRC, "gather.cu")).read()
    for old, new in _EDITS + VARIANTS.get(variant, []):
        if src.count(old) != 1:
            raise RuntimeError(f"gather_phases: {old!r} is not in "
                               f"csrc/gather.cu once")
        src = src.replace(old, new)
    return src


def load(variant=None):
    src = stamped_source(variant)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    base = os.path.join(cuda_build.BUILD_DIR, f"gather_phases_{tag}")
    if not os.path.exists(base + ".so"):
        with open(base + ".cu", "w") as f:
            f.write(src)
        res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                              "-o", base + ".so", base + ".cu"],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(base + ".so")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gather_run.argtypes = [I, P, P, P, I, I, I, I, I, P]
    lib.set_stamps.argtypes = [P]
    return lib


def run(lib, n, lanes=None, ranges=None, variant=None, reps=20):
    """Stamps of the last of `reps` launches at the plan; returns a dict of
    the plan and each phase's mean and largest cycles a block."""
    dev = torch.device("cuda")
    plan = pp.onehot_plan(n, pp._sm_count(dev), lanes, ranges)
    table, idx = pp.probe_inputs("random", n, dev)
    tab = pp._kernel_table(table, "onehot")
    out = torch.empty(n, 4, device=dev)
    stamps = torch.zeros(plan.ctas * 8, dtype=torch.int64, device=dev)
    lib.set_stamps(stamps.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k in (1, reps):          # a warm-up launch, then the run
        rc = lib.gather_run(3, tab.data_ptr(), idx.data_ptr(),
                            out.data_ptr(), n, table.shape[0], k,
                            plan.lanes, plan.ranges, ctypes.c_void_p(stream))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    if variant is None and not torch.equal(
            out, table[(idx.long() + reps - 1) % table.shape[0]]):
        raise AssertionError("stamped kernel: wrong rows")
    s = stamps.view(-1, 8).cpu().numpy().astype(np.int64)
    d = np.diff(s[:, :5], axis=1)
    res = {"plan": plan._asdict(), "variant": variant}
    for i, name in enumerate(("rows_histogram", "scan", "scatter", "tiles")):
        res[name] = (float(d[:, i].mean()), int(d[:, i].max()))
    res["total"] = (float((s[:, 4] - s[:, 0]).mean()),
                    int((s[:, 4] - s[:, 0]).max()))
    res["span_us"] = float(s[:, 7].max() - s[:, 6].min()) / 1e3
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m nmcfluid_torch.wost.gather_phases")
    ap.add_argument("--variant", choices=tuple(VARIANTS), default=None)
    ap.add_argument("--plan", action="append", default=None,
                    help="n[,lanes,ranges]; repeatable (default: the "
                         "plan's choice at 524288 and 65536)")
    args = ap.parse_args(argv)
    get_device("cuda")
    lib = load(args.variant)
    plans = [[int(x) for x in p.split(",")] for p in args.plan] \
        if args.plan else [[524288], [65536]]
    out = []
    for p in plans:
        res = run(lib, *p, variant=args.variant)
        out.append(res)
        phases = "  ".join(f"{k} {res[k][0]:.0f}/{res[k][1]}" for k in
                           ("rows_histogram", "scan", "scatter", "tiles",
                            "total"))
        pl = res["plan"]
        print(f"[{args.variant or 'kernel'}] n {pl['n']} chunks "
              f"{pl['chunks']} x {pl['lanes']} lanes x {pl['ranges']} "
              f"ranges ({pl['ctas']} blocks): cycles a block (mean/max) "
              f"{phases}; first start to last end {res['span_us']:.2f} us",
              flush=True)
    return out


if __name__ == "__main__":
    main()
