"""The Taylor-Green velocity error (port of the metric part of
nmcfluid/transport/density.py, move_density.py 2d:97-146).

The grid is N cells per axis with vertex-at-lo coordinates
lo + i/N*(hi-lo); the error is the mean over it of |u_net - u_TG|^2 for
the RAW network velocity, against the analytic field on angles i/N*2pi
(reproduced as the reference computes it).
"""
import numpy as np
import torch

from ..models.siren import apply_siren


def _index_grid(scene_size, n, dim, device="cpu"):
    axes = [torch.arange(n, dtype=torch.float32, device=device) / n
            * (scene_size[1] - scene_size[0]) + scene_size[0]
            for _ in range(dim)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def raw_velocity_grid(fluid, params, n):
    """Raw network velocity (no BCs) on the transport grid (2d:120)."""
    pts = _index_grid(fluid.scene.scene_size, n, fluid.scene.dim,
                      params[0][0].device)
    with torch.no_grad():
        return apply_siren(params, fluid.siren_cfg, pts)


def taylor_green_truth(n):
    """The analytic steady TG field on the i/N*2pi grid (2d:105-106)."""
    ang = np.arange(n) / n * 2.0 * np.pi
    ax, ay = np.meshgrid(ang, ang, indexing="ij")
    return np.stack([np.sin(ax) * np.cos(ay),
                     -np.cos(ax) * np.sin(ay)], axis=-1)


def tg_velocity_error(vel_grid, truth=None):
    """mean |u - u_TG|^2 over the grid (2d:143-146)."""
    n = vel_grid.shape[0]
    if truth is None:
        truth = taylor_green_truth(n)
    v = vel_grid.detach().cpu().numpy() if isinstance(vel_grid, torch.Tensor) \
        else np.asarray(vel_grid)
    diff = v - truth
    return float(np.mean(np.sum(diff ** 2, axis=-1)))
