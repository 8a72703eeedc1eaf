"""Matplotlib renderers for velocity, vorticity and density frames (a copy
of nmcfluid/utils/vis.py, src/{2d,3d}/utils/vis_utils.py): quiver plots
for vector fields, images of scalar fields, gif assembly. Headless (Agg).
matplotlib and imageio are imported when first used, so the package and
its simulation run on machines without them; the CLI checks for
matplotlib before it simulates under --draw, and without it writes 2D
density frames as npz (run.py).
"""
import os

import numpy as np


def have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_vector_field2d(u, v, x, y, path, figsize=(6, 6)):
    """vis_utils.py:8-33 (quiver)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=figsize)
    ax.quiver(x, y, u, v)
    ax.set_aspect("equal")
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", pad_inches=0, dpi=120)
    plt.close(fig)


def draw_scalar_field2d(arr, path, vmin=None, vmax=None, cmap="bwr",
                        figsize=(6, 6)):
    """vis_utils.py:36-61 (imshow of a scalar grid)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=figsize)
    ax.imshow(np.asarray(arr).T, origin="lower", vmin=vmin, vmax=vmax,
              cmap=cmap)
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", pad_inches=0, dpi=120)
    plt.close(fig)


def draw_scatter(pts, vals, path, cmap="viridis", figsize=(6, 6)):
    """model_split.py:291-297 (pressure cloud scatter)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=figsize)
    sc = ax.scatter(pts[:, 0], pts[:, 1], c=vals, cmap=cmap, s=0.1)
    ax.set_axis_off()
    plt.colorbar(sc)
    fig.savefig(path, bbox_inches="tight", pad_inches=0, dpi=120)
    plt.close(fig)


def frames_to_gif(frame_dir, pattern, out_path, fps=10):
    """vis_utils.py:103-106; None without imageio or frames."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    files = sorted(f for f in os.listdir(frame_dir) if pattern in f
                   and f.endswith(".png"))
    if not files:
        return None
    imgs = [imageio.imread(os.path.join(frame_dir, f)) for f in files]
    imageio.mimsave(out_path, imgs, fps=fps)
    return out_path


def save_txt_grid(path, arr):
    """main.py:178-188 txt dumps: flatten leading grid dims."""
    a = np.asarray(arr)
    np.savetxt(path, a.reshape(-1, a.shape[-1]) if a.ndim > 2
               else a.reshape(-1, 1))
