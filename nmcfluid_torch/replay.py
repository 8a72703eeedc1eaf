"""Checkpoint replay tools of the port (port of nmcfluid/replay.py):
kinetic-energy curves and field re-rendering.

    python -m nmcfluid_torch.replay <scene> {energy,vorticity,velocity} \\
        --exp DIR [--resolution N] [--fmt infer|run] [--device cpu]

energy writes Ek_r<res>.txt (0.5 sum u^2 a frame, src/3d/infer.py:16-39)
or, with --fmt run, the run dir's energy.txt (0.5 mean u^2 a frame);
vorticity draws 2D vorticity pngs (src/3d/draw.py:26-37); velocity draws
2D quiver pngs or writes 3D velocity npz files (as does vorticity in 3D).
Checkpoints of either package replay here. Runs on the card unless
--device cpu.
"""
import argparse
import os

import numpy as np

from .scenes import SCENES, get_scene
from .sim import sampling
from .sim.fluid import NeuralFluid
from .utils.checkpoint import latest_step, load_ckpt
from .utils.keys import Key


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scene", choices=sorted(SCENES))
    p.add_argument("what", choices=["energy", "vorticity", "velocity"])
    p.add_argument("--exp", required=True, help="experiment dir (with model/)")
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--fmt", choices=["infer", "run"], default="infer",
                   help="energy output format: 'infer' = Ek_r<res>.txt "
                        "(0.5*sum u^2, infer.py:16-39); 'run' = regenerate "
                        "the run dir's energy.txt (0.5*mean u^2 per frame, "
                        "run.py's kinetic_energy minus the mean-pressure "
                        "term P, which checkpoints do not store)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card, and an error "
                        "without one); 'cpu' runs on the CPU")
    return p


def _np(t):
    return t.detach().cpu().numpy()


def main(argv=None):
    args = build_parser().parse_args(argv)
    scene = get_scene(args.scene)
    fluid = NeuralFluid(scene, max_n_iters=1, device=args.device)
    dev = fluid.device
    res = args.resolution or scene.vel_vis_resolution
    model_dir = os.path.join(args.exp, "model")
    last = latest_step(model_dir)
    if last < 0:
        raise SystemExit(f"no checkpoints under {model_dir}")
    st = fluid.init_state(key=Key.from_seed(0))

    if args.what == "energy":
        # infer.py:16-39: Ek = 0.5 sum u^2 on the vis grid, plus source Ek
        pts = sampling.uniform_grid(scene.scene_size, res, True, device=dev)
        eks, means = [], []
        for t in range(last + 1):
            params, _ = load_ckpt(model_dir, st.params, t)
            u = _np(fluid.velocity(params, pts, eps=st.eps, t=t))
            eks.append(0.5 * float(np.sum(u ** 2)))
            means.append(0.5 * float(np.mean(u ** 2)))
        if args.fmt == "run":
            # row k = energy after step k+1: drop the frame-0 row
            out = os.path.join(args.exp, "energy.txt")
            np.savetxt(out, np.asarray(means[1:]))
            print(f"wrote {out} ({len(means) - 1} frames, 0.5*mean|u|^2; "
                  "the per-run mean-pressure offset P is not in ckpts)")
            return
        ek_src = 0.5 * float(np.sum(_np(scene.source_velocity(
            pts, key=Key.from_seed(0))) ** 2))
        out = os.path.join(args.exp, f"Ek_r{res}.txt")
        with open(out, "w") as f:
            print(f"Ek src:\n{ek_src}", file=f)
            print("Ek list:", file=f)
            for e in eks:
                print(e, file=f)
        print(f"wrote {out} ({len(eks)} frames)")
        return

    from .ops.diff_ops import curl2d
    from .utils import vis
    save_dir = os.path.join(args.exp, f"{args.what}_{res}")
    os.makedirs(save_dir, exist_ok=True)
    grid = sampling.uniform_grid(scene.scene_size, res, device=dev)
    for t in range(last + 1):
        params, _ = load_ckpt(model_dir, st.params, t)
        if args.what == "vorticity" and scene.dim == 2:
            w = _np(curl2d(
                lambda x: fluid.velocity(params, x, eps=st.eps, t=t), grid))
            vis.draw_scalar_field2d(
                w, os.path.join(save_dir, f"vorticity_t{t:03d}.png"),
                vmin=-5, vmax=5)
        else:
            u = _np(fluid.velocity(params, grid, eps=st.eps, t=t))
            if scene.dim == 2:
                g = _np(grid)
                vis.draw_vector_field2d(
                    u[..., 0], u[..., 1], g[..., 0], g[..., 1],
                    os.path.join(save_dir, f"velocity_t{t:03d}.png"))
            else:
                np.savez_compressed(
                    os.path.join(save_dir, f"velocity_t{t:03d}.npz"), u=u)
    vis.frames_to_gif(save_dir, args.what,
                      os.path.join(save_dir, f"{args.what}_anim.gif"))
    print(f"wrote {save_dir}")


if __name__ == "__main__":
    main()
