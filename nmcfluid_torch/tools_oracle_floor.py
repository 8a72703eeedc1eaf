"""Oracle the TG error floor: fits target the ANALYTIC field directly
(port of nmcfluid/tools_oracle_floor.py).

Runs the 50-frame cadence with every fit targeting the analytic steady
Taylor-Green field — no Monte Carlo, no semi-Lagrangian backtrace, no
pressure solve, no target compounding. Two fits per frame (matching the
advect+project cadence and its noise injections), chained from the
previous frame's params exactly like the real stepper, under the
production fit recipe (on the card every fit is one launch of the fit
kernel, csrc/fitkernel.cu, then ls_head). The resulting curve is the
irreducible refit-compounding floor: the part of the error budget a
better projection could never remove.

Reference for the error metric: src/2d/move_density.py:143-152 (mean
squared L2 velocity error on the 1000^2 grid) — same code path as
run.py's error_ours.txt (transport.density.tg_velocity_error).

Usage: python -m nmcfluid_torch.tools_oracle_floor [--frames 50]
       [--fits_per_frame 2] [--out oracle_floor.txt] [--device cpu]
"""
import argparse
import json
import time

import numpy as np
import torch

from .scenes import get_scene
from .sim.fluid import NeuralFluid, _fit_source
from .transport.density import raw_velocity_grid, tg_velocity_error
from .utils.keys import Key


def oracle_floor(fluid, state, frames, fits_per_frame=2, grid=1000):
    """From an add_source state, `fits_per_frame` source fits a frame
    chained from the previous params, each on the next key.split();
    yields (frame, TG velocity error on the raw grid-wide velocity)."""
    params, key = state.params, state.key
    for frame in range(1, frames + 1):
        for _ in range(fits_per_frame):
            key, kf = key.split()
            params, _ = _fit_source(fluid, params, kf, state.eps,
                                    state.timestep)
        yield frame, tg_velocity_error(raw_velocity_grid(fluid, params,
                                                         grid))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--fits_per_frame", type=int, default=2)
    ap.add_argument("--out", default="oracle_floor.txt")
    ap.add_argument("--max_n_iters", type=int, default=None)
    ap.add_argument("--grid", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card, and an error "
                         "without one); 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    fluid = NeuralFluid(get_scene("taylorgreen"),
                        max_n_iters=args.max_n_iters, device=args.device)
    state = fluid.add_source(fluid.init_state(key=Key.from_seed(0)))
    errors = []
    t0 = time.time()
    for frame, err in oracle_floor(fluid, state, args.frames,
                                   args.fits_per_frame, args.grid):
        errors.append(err)
        print(f"frame {frame}: oracle_err={err:.6e}", flush=True)
    np.savetxt(args.out, errors)
    dev = fluid.device
    print(json.dumps({
        "mean_err_frames_1_to_n": float(np.mean(errors)),
        "first": errors[0], "last": errors[-1],
        "frames": args.frames, "fits_per_frame": args.fits_per_frame,
        "sec_total": round(time.time() - t0, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)), "out": args.out}))


if __name__ == "__main__":
    main()
