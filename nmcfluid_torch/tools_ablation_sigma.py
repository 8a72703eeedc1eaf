"""Screening-weight ablation snapshots (final_material/screening_weight;
port of nmcfluid/tools_ablation_sigma.py).

The reference publishes the karman first-projection *pressure field* at
absorptionCoeff sigma in {50, 100, 350} (weight=NN.png: viridis,
limits +-0.02, obstacle blanked): larger sigma localizes the screened
response around the cylinder AND shortens/denoises the MC walks. This
tool reproduces those snapshots with the MC (WoSt) estimator — the MC
path is the point: the published sigma=50 image is visibly noisier than
sigma=350, which is a solver-variance statement, so the deterministic
projections would miss it. Drawing needs matplotlib: where it is missing
the command is refused at parsing.

`python -m nmcfluid_torch.tools_ablation_sigma [--sigmas 50 100 350]
 [--res 256] [--out docs/ablations] [--device cpu]`
"""
import argparse
import dataclasses
import os

import numpy as np
import torch

from .utils.keys import Key
from .utils.vis import have_matplotlib


def pressure_snapshot(fluid, state, res, n_walks=None, chunk=None,
                      walk_step_cap=None, seed=0):
    """The first projection's pressure on a (res, res * aspect) grid of the
    scene box, walked from add_source state's divergence grid in chunks of
    `chunk` points (default: the fluid's wost_chunk), chunk i keyed
    seed + i. Returns (p (ny, nx) numpy, gx, gy)."""
    from .sim.fluid import _divergence_grid
    from .wost.solver import estimate_solution_and_gradient
    scene = fluid.scene
    div = _divergence_grid(fluid, state.params, state.eps, state.timestep)
    ss = scene.scene_size
    aspect = (ss[1] - ss[0]) / (ss[3] - ss[2])
    ny, nx = res, int(round(res * aspect))
    xs = np.linspace(ss[0], ss[1], nx, dtype=np.float32)
    ys = np.linspace(ss[2], ss[3], ny, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([gx, gy], -1).reshape(-1, 2)

    ws_kw = dict(n_walks=n_walks or scene.n_walks)
    if walk_step_cap:
        ws_kw["walk_step_cap"] = walk_step_cap
    ws = scene.walk_settings(**ws_kw)
    chunk = chunk or fluid.wost_chunk
    p_parts = []
    for i in range(0, pts.shape[0], chunk):
        sub = pts[i:i + chunk]
        pad = chunk - sub.shape[0]
        if pad:
            sub = np.concatenate([sub, sub[:1].repeat(pad, 0)])
        p, _, _ = estimate_solution_and_gradient(
            fluid._wost_scene, ws, torch.as_tensor(sub, device=fluid.device),
            Key.from_seed(seed + i), source_args=(div,))
        p_parts.append(p.cpu().numpy()[:chunk - pad])
    return np.concatenate(p_parts).reshape(ny, nx), gx, gy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="karman")
    ap.add_argument("--sigmas", type=float, nargs="+",
                    default=[50.0, 100.0, 350.0])
    ap.add_argument("--res", type=int, default=256,
                    help="vertical grid resolution of the snapshot")
    ap.add_argument("--n_walks", type=int, default=None)
    ap.add_argument("--max_n_iters", type=int, default=None,
                    help="IC-fit iteration cap (tests)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="points per walk launch (default: the fluid's "
                         "wost_chunk)")
    ap.add_argument("--walk_step_cap", type=int, default=None)
    ap.add_argument("--vlim", type=float, default=0.02)
    ap.add_argument("--out", default="docs/ablations")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card, and an error "
                         "without one); 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    if not have_matplotlib():
        ap.error("the snapshots need matplotlib, which is not installed")
    from .scenes import get_scene
    from .sim.fluid import NeuralFluid
    from .utils.vis import _plt
    plt = _plt()

    base = get_scene(args.scene)
    for sigma in args.sigmas:
        scene = dataclasses.replace(base, absorption=float(sigma))
        fluid = NeuralFluid(scene, max_n_iters=args.max_n_iters,
                            device=args.device)
        os.makedirs(args.out, exist_ok=True)   # once a device is granted
        # IC fit -> realistic div field
        state = fluid.add_source(fluid.init_state(key=Key.from_seed(0)))
        p, gx, gy = pressure_snapshot(
            fluid, state, args.res, args.n_walks, args.chunk,
            args.walk_step_cap, seed=int(sigma) * 1000)

        # blank the obstacle interior like the published figures
        if scene.obstacle_center is not None:
            d = np.hypot(gx - scene.obstacle_center[0],
                         gy - scene.obstacle_center[1])
            p = np.where(d < scene.obstacle_radius, np.nan, p)

        ss = scene.scene_size
        aspect = (ss[1] - ss[0]) / (ss[3] - ss[2])
        fig, ax = plt.subplots(
            figsize=(10, 10 / aspect + 1.2), constrained_layout=True)
        im = ax.imshow(p, origin="lower", cmap="viridis",
                       vmin=-args.vlim, vmax=args.vlim,
                       extent=(ss[0], ss[1], ss[2], ss[3]))
        ax.set_axis_off()
        fig.colorbar(im, ax=ax, fraction=0.025)
        path = os.path.join(args.out, f"sigma_{int(sigma)}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        finite = p[np.isfinite(p)]
        print(f"sigma={sigma}: wrote {path}  p range "
              f"[{finite.min():.4f}, {finite.max():.4f}]  "
              f"std {finite.std():.5f}", flush=True)


if __name__ == "__main__":
    main()
