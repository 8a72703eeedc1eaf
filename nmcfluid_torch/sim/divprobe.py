"""Repeat the small-input divergence-grid check on the card.

    python -m nmcfluid_torch.sim.divprobe [--scene karman] [--repeats 5] \\
        [--out FILE.npz]

The check of tests/test_torch_gpu.py's WoSt-chunk tests and of
chip_smoke.py::check_small_input: the scene's divergence grid at
div_resolution 64 (24 in 3D) from init_state(3)'s weights, at the ramp
width the path steps with, on the card and on the CPU. It is run
--repeats times in this process, and the probe prints whether the grid
points and each device's grid keep the same bits every time, the largest
|card - CPU| and how many cells leave the check's rtol 1e-4 / atol 5e-5,
and each device's largest distance from a float64 grid computed on the
CPU from the same weights (float64 but for the obstacle SDF's square
root). --out saves the first grid of each device, to compare them across
processes or trees.

Needs a CUDA card; without one it exits with an error.
"""
import argparse

import numpy as np
import torch

from ..scenes import get_scene
from . import fluid as tfluid

RTOL, ATOL = 1e-4, 5e-5        # the check's tolerance


def _fluid(name, device):
    scene = get_scene(name)
    return tfluid.NeuralFluid(
        scene, device=device, sample_resolution=16, wost_resolution=16,
        div_resolution=64 if scene.dim == 2 else 24, n_walks=48,
        max_n_iters=50, fit_pool=8)


def float64_grid(fluid, params, eps, t):
    """-div u on the fluid's divergence grid in float64 on the CPU, by the
    jvps of tfluid._divergence_grid."""
    from .sampling import uniform_grid
    pts = uniform_grid(fluid.scene.scene_size, fluid.div_resolution).double()
    x = pts.reshape(-1, fluid.scene.dim)
    p64 = [(W.double().cpu(), b.double().cpu()) for W, b in params]
    div = torch.zeros(x.shape[0], dtype=torch.float64)
    with torch.no_grad():
        for d in range(fluid.scene.dim):
            tan = torch.zeros_like(x)
            tan[:, d] = 1.0
            _, du = torch.func.jvp(
                lambda y: fluid.velocity(p64, y, eps=eps, t=t), (x,), (tan,))
            div = div + du[:, d]
    return (-div).reshape(pts.shape[:-1])


def run(name, repeats):
    """The readings above, as a dict, and the first grid of each device."""
    gpu, cpu = _fluid(name, "cuda"), _fluid(name, "cpu")
    params = gpu.init_state(3).params
    params_cpu = [(W.cpu(), b.cpu()) for W, b in params]
    eps = gpu.scene.eps_after_source(gpu.scene.bdry_eps)
    from .sampling import uniform_grid
    pts_g = uniform_grid(gpu.scene.scene_size, gpu.div_resolution,
                         device="cuda").cpu()
    pts_c = uniform_grid(cpu.scene.scene_size, cpu.div_resolution)
    grids = {"card": [], "cpu": []}
    for _ in range(repeats):
        grids["card"].append(
            tfluid._divergence_grid(gpu, params, eps, 1).cpu())
        grids["cpu"].append(tfluid._divergence_grid(cpu, params_cpu, eps, 1))
    g, c = grids["card"][0], grids["cpu"][0]
    ref = float64_grid(cpu, params_cpu, eps, 1)
    diff = (g - c).abs()
    out = {
        "points_equal": bool(torch.equal(pts_g, pts_c)),
        "card_repeats_equal": all(torch.equal(g, h) for h in grids["card"]),
        "cpu_repeats_equal": all(torch.equal(c, h) for h in grids["cpu"]),
        "max_card_cpu": float(diff.max()),
        "cells_outside": int((diff > ATOL + RTOL * c.abs()).sum()),
        "max_card_f64": float((g.double() - ref).abs().max()),
        "max_cpu_f64": float((c.double() - ref).abs().max()),
        "max_abs_grid": float(ref.abs().max()),
        "threads": torch.get_num_threads(),
        "cpu_capability": torch.backends.cpu.get_cpu_capability()}
    return out, g, c


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nmcfluid_torch.sim.divprobe")
    ap.add_argument("--scene", default="karman")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("divprobe: needs a CUDA device")
    res, g, c = run(args.scene, args.repeats)
    print(f"{args.scene} divergence grid, card vs CPU: "
          + ", ".join(f"{k} {v}" for k, v in res.items()), flush=True)
    if args.out:
        np.savez(args.out, card=g.numpy(), cpu=c.numpy())
    return res


if __name__ == "__main__":
    main()
