"""The readings that the check's limits (limits/<cell>.json) are set from.

    python3 -m nmcbench.readings --workload <cell> --seeds S1 S2 ... \
        [--control 3] [--out F.jsonl]

On the card, for each seed: one frame through the harness at the cell's
own size (set-up, a window of one frame, the check), whose numbers are a
sound run's (the lower readings). For the first --control seeds also:
  - the control: the reference put in the program's place in TF32, at the
    frame's own questions (reference/control.py), checked;
  - the fits' faults, read on the reference put in the program's place:
    a fit that returns its start unchanged, and a fit over half of each
    batch's points (the mean over the rest), each as the gap to the
    float32 reference fit;
  - under the walk, its answers altered where they are produced: the
    gradient estimates scaled by 0.9, and given to the wrong points (a
    permutation), read by the walk's numbers.
One JSON line a reading, on stdout and appended to --out.
"""
import argparse
import json
import sys
import time


def _line(out, obj):
    s = json.dumps(obj, default=str)
    print(s, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(s + "\n")


def fit_faults(rec, phase):
    from nmcbench.reference import check as C
    from nmcbench.reference import frame as F
    ph = rec.phases[phase]
    pool = ph["pool"]
    ref = F.adam_fit(ph["params0"], pool, ph["n_iters"], ph["lr"], "f32")
    w = pool[4].clone()
    w[:, w.shape[1] // 2:] = 0.0
    half = F.adam_fit(ph["params0"], pool[:4] + (w,), ph["n_iters"],
                      ph["lr"], "f32")
    return {f"{phase}_fit.unchanged": C.fit_gap(ph["params0"], ref, pool),
            f"{phase}_fit.half_batch": C.fit_gap(half, ref, pool)}


def walk_faults(scene, rec, seed):
    import torch
    from nmcbench.reference import check as C
    out = {}
    g0 = rec.grad_p
    try:
        rec.grad_p = g0 * 0.9
        out["scaled_0.9"] = C.check_projection(scene, rec, {})
        gen = torch.Generator(device=g0.device)
        gen.manual_seed(seed)
        perm = torch.randperm(g0.shape[0], generator=gen, device=g0.device)
        rec.grad_p = g0[perm]
        out["permuted"] = C.check_projection(scene, rec, {})
    finally:
        rec.grad_p = g0
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m nmcbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cpu rehearses the readings (tiny cells in tests)")
    args = p.parse_args(argv)
    from nmcbench import run as R
    from nmcbench.reference import check as C
    from nmcbench.reference.control import control_record
    from nmcbench.reference.frame import Scene
    cell = R.Cell(args.workload)
    scene = Scene(cell.cfg, cell.scene_ref)
    for i, seed in enumerate(args.seeds):
        keep = {}
        t = time.perf_counter()
        res, notes = R.run_cell(cell, seed, 1e-3, 0, args.device, t,
                                 keep=keep, check_frames=1)
        _line(args.out, {"cell": cell.name, "seed": seed, "kind": "sound",
                         "numbers": notes["check_numbers"],
                         "frame_s": notes["window_s"],
                         "check_s": notes["check_s"],
                         "notes": notes["check_notes"]})
        if i >= args.control:
            continue
        rec = keep["record"]
        t = time.perf_counter()
        nums, _ = C.check_frame(scene, control_record(scene, rec, "tf32"))
        _line(args.out, {"cell": cell.name, "seed": seed, "kind": "control",
                         "numbers": nums, "s": time.perf_counter() - t})
        faults = {}
        for phase in ("adv", "prj"):
            faults.update(fit_faults(rec, phase))
        if rec.projection == "wost":
            faults.update(walk_faults(scene, rec, seed))
        _line(args.out, {"cell": cell.name, "seed": seed, "kind": "faults",
                         "numbers": faults})
    return 0


if __name__ == "__main__":
    sys.exit(main())
