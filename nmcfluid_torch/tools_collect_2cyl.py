"""Collect the karman2cyl 100-frame e2e artifacts (port of
nmcfluid/tools_collect_2cyl.py).

Copies vorticity frames from the wost and bem runs, and computes the
cross-solver gap: per-frame kinetic-energy curves plus the early-frame
velocity-field L2 gap (before chaotic divergence makes pointwise
comparison meaningless) evaluated from the saved checkpoints, which may
come from either package.

Usage: python -m nmcfluid_torch.tools_collect_2cyl \
           --wost RUN/karman2cyl --bem RUN/karman2cyl --out DIR \
           [--device cpu]
"""
import argparse
import json
import os
import shutil

import numpy as np
import torch

from .utils.keys import Key


def _curves(fluid, like, runs, pts, mask, eps, gap_frames, n_frames=100):
    """(relative velocity gaps of the first gap_frames frames both runs
    have, 0.5 mean |u|^2 curves of each run on the fluid mask)."""
    from .utils.checkpoint import load_ckpt

    def vel(run_dir, t):
        p, _ = load_ckpt(os.path.join(run_dir, "model"), like, t)
        with torch.no_grad():
            return fluid.velocity(p, pts, eps=eps).cpu().numpy()

    def exists(run_dir, t):
        return os.path.exists(os.path.join(
            run_dir, "model", f"ckpt_step_t{t:03d}.npz"))

    gaps = []
    for t in range(1, gap_frames + 1):
        if not all(exists(d, t) for d in runs):
            break
        uw, ub = (vel(d, t) for d in runs)
        num = np.sqrt(np.mean(np.sum((uw - ub) ** 2, -1)[mask]))
        den = np.sqrt(np.mean(np.sum(uw ** 2, -1)[mask])) + 1e-12
        gaps.append(float(num / den))
    # 2D runs write no energy.txt (that is the 3d/main.py surface);
    # compute 0.5 mean |u|^2 on the fluid mask from the checkpoints
    energies = []
    for d in runs:
        out = []
        for t in range(1, n_frames + 1):
            if not exists(d, t):
                break
            out.append(0.5 * float(np.mean(np.sum(vel(d, t) ** 2,
                                                  -1)[mask])))
        energies.append(np.asarray(out) if out else None)
    return gaps, energies


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--wost", required=True)
    ap.add_argument("--bem", required=True)
    ap.add_argument("--out", default="docs/karman2cyl_r5")
    ap.add_argument("--frames", default="10,50,100")
    ap.add_argument("--gap_frames", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card, and an error "
                         "without one); 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    from .scenes import get_scene
    from .sim import sampling
    from .sim.fluid import NeuralFluid

    scene = get_scene("karman2cyl")
    fl = NeuralFluid(scene, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    for tag, d in (("wost", args.wost), ("bem", args.bem)):
        for t in args.frames.split(","):
            src = os.path.join(d, "vorticity", f"vorticity_t{int(t):03d}.png")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(
                    args.out, f"vorticity_{tag}_t{int(t):03d}.png"))
        e = os.path.join(d, "energy.txt")
        if os.path.exists(e):
            shutil.copy(e, os.path.join(args.out, f"energy_{tag}.txt"))

    like = fl.init_state(key=Key.from_seed(0)).params
    eps = scene.eps_after_source(scene.bdry_eps)   # as the CLI steps
    pts = sampling.uniform_grid(scene.scene_size, 128,
                                device=fl.device).reshape(-1, 2)
    mask = scene.fluid_mask(pts).cpu().numpy()
    gaps, (ew, eb) = _curves(fl, like, (args.wost, args.bem), pts, mask,
                             eps, args.gap_frames)
    if ew is not None:
        np.savetxt(os.path.join(args.out, "energy_wost.txt"), ew)
    if eb is not None:
        np.savetxt(os.path.join(args.out, "energy_bem.txt"), eb)
    rep = {
        "frames_compared": len(gaps),
        "rel_velocity_gap_per_frame": [round(g, 5) for g in gaps],
        "energy_final": {
            "wost": float(ew[-1]) if ew is not None else None,
            "bem": float(eb[-1]) if eb is not None else None,
        },
        "energy_rel_gap_final": (
            float(abs(ew[-1] - eb[-1]) / (abs(ew[-1]) + 1e-12))
            if ew is not None and eb is not None
            and len(ew) == len(eb) else None),
    }
    with open(os.path.join(args.out, "cross_solver_gap.json"), "w") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
