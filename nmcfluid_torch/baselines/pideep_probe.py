"""piDeepONet closure experiments (port of
nmcfluid/baselines/pideep_probe.py).

The published error_pideeponet.txt is flat at the half-texel evaluation
floor (3.945e-3 vs floor 3.9437e-3), so the original's true fit quality
is unrecoverable from the publication. These probes decide between two
hypotheses for the architecture-faithful rebuild's honest error:

  * capacity: 60 total coefficients (20/field) cannot represent the
    steady TG field  ->  probe `supervised` trains the SAME architecture
    with a pure supervised regression onto the analytic velocity (no
    physics losses). Its converged honest error is a lower bound for ANY
    training of this architecture.
  * optimization: the composite PINN objective (init+bound+NS+div over
    t in [0, 2.5], experiments/piDeepONetSolver/model.py:171-215) is
    what stalls  ->  probe `coef` re-runs the physics fit at 60/150/300
    coefficients; if the error does not move with capacity, the
    objective, not the basis size, sets the floor.

Usage: python -m nmcfluid_torch.baselines.pideep_probe {supervised,coef}
       [--n_out 60 ...] [--max_n_iters 50000] [--out results_baselines]
       [--device cpu]
"""
import argparse
import os
import time

import numpy as np
import torch

from .. import get_device
from ..utils.keys import Key
from .common import (adam_fit, centers_grid, ref_pipeline_error,
                     sample_interior, tg_error_curve_grid, tg_velocity)
from .pideeponet import PIDeepONetFluid
from .run import error_of, evaluate


def train_supervised(m, state, key):
    """Pure regression of the DeepONet inner-product head onto the
    analytic TG velocity over the full (x, t in [0, t_range]) training
    domain — the capacity bound (no physics terms)."""
    def loss_fn(st, ki):
        k0, k1 = ki.split(2)
        x = sample_interior(k0, m.n, m.device)
        tt = k1.uniform((m.n, 1), m.device) * m.t_range
        xt = torch.cat([x, tt], -1)
        return torch.mean((m.field(st, xt)[..., :2] - tg_velocity(x)) ** 2)
    return adam_fit(state, key, loss_fn, m.lr, m.max_n_iters,
                    exp_gamma=0.95 ** 1e-4)


def curve(m, st, frames, dt, grid):
    """(honest errors, refpipe errors) of frames 1..frames."""
    coords, truth = tg_error_curve_grid(grid)
    coords_ref = centers_grid(50)
    errs, errs_ref = [], []
    for f in range(frames):
        t = (f + 1) * dt

        def vel(x):
            return m.velocity(st, x, t)
        errs.append(error_of(vel, coords, truth, m.device))
        errs_ref.append(ref_pipeline_error(
            evaluate(vel, coords_ref, m.device), "pideeponet"))
    return errs, errs_ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", choices=["supervised", "coef"])
    ap.add_argument("--n_out", type=int, nargs="+", default=None)
    ap.add_argument("--max_n_iters", type=int, default=50_000)
    ap.add_argument("--sample_resolution", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--dt", type=float, default=0.001)
    ap.add_argument("--grid", type=int, default=1000)
    ap.add_argument("--out", default="results_baselines")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card, and an error "
                         "without one); 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    key = Key.from_seed(0)

    n_outs = args.n_out or ([60] if args.probe == "supervised"
                            else [60, 150, 300])
    for n_out in n_outs:
        m = PIDeepONetFluid(max_n_iters=args.max_n_iters, lr=args.lr,
                            sample_resolution=args.sample_resolution,
                            n_out=n_out, device=device)
        st = m.init(key=Key.from_seed(0))
        t0 = time.time()
        if args.probe == "supervised":
            st, i, loss = train_supervised(m, st, key)
        else:
            st, i, loss = m.train(st, key)
        print(f"[{args.probe} n_out={n_out}] trained {i} iters, "
              f"loss {float(loss):.3e} ({time.time() - t0:.1f}s)",
              flush=True)
        errs, errs_ref = curve(m, st, args.frames, args.dt, args.grid)
        tag = f"{args.probe}_n{n_out}"
        np.savetxt(os.path.join(args.out, f"probe_pideep_{tag}.txt"), errs)
        np.savetxt(os.path.join(args.out, f"probe_pideep_{tag}_refpipe.txt"),
                   errs_ref)
        print(f"[{args.probe} n_out={n_out}] honest mean "
              f"{np.mean(errs):.6e}  refpipe mean {np.mean(errs_ref):.6e}",
              flush=True)


if __name__ == "__main__":
    main()
