"""Passive density transport and the Taylor-Green error metric (port of
nmcfluid/transport/density.py, move_density.py 2d and 3d).

Each checkpoint's RAW network velocity (no boundary conditions,
move_density.py 2d:120, 3d:211) is evaluated on the transport grid, and
the density is pulled back semi-Lagrangianly with linear interpolation,
computed as jax.scipy.ndimage.map_coordinates(order=1) computes it.

Grid convention (2d:97-101, 3d:186-190): N cells per axis with
vertex-at-lo coordinates lo + i/N*(hi-lo) (not cell-centered), the
backtraced index (x - lo) * N / (hi - lo); 2D reads 0 outside the grid,
3D clamps ('nearest').

The Taylor-Green error is the mean over the grid of |u_net - u_TG|^2 for
the raw network velocity, against the analytic field on angles i/N*2pi
(reproduced as the reference computes it).
"""
import numpy as np
import torch

from ..models.siren import apply_siren
from ..utils.keys import Key

# points per network evaluation: the 3D 200^3 grid holds 8 M points, and
# each live activation of a 64-wide net would take 2 GiB at once
CHUNK = 1 << 18


def _index_grid(scene_size, n, dim, device="cpu"):
    axes = [torch.arange(n, dtype=torch.float32, device=device) / n
            * (scene_size[1] - scene_size[0]) + scene_size[0]
            for _ in range(dim)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def init_density(scene, n, key=None, device="cpu"):
    """The initial density |source velocity| on the transport grid
    (move_density.py 2d:44-58, 3d:49-117); smoke's jitter is drawn from
    `key` (default Key(0), as the JAX package's PRNGKey(0)). For
    vortex_collide returns (density, the red/blue ring colour grid)
    (3d:112-116)."""
    pts = _index_grid(scene.scene_size, n, scene.dim, device)
    vel = scene.source_velocity(pts, key=Key(0) if key is None else key)
    d = torch.linalg.vector_norm(vel, dim=-1)
    if scene.name == "vortex_collide":
        def ring(z):
            c = torch.tensor([0.0, 0.0, z], device=device)
            return (torch.linalg.vector_norm(pts - c, dim=-1) < 0.2).to(
                torch.float32)
        return d, torch.stack([ring(-0.21), torch.zeros_like(d),
                               ring(0.21)], dim=-1)
    return d


def advect_density(d_grid, vel_grid, scene_size, dt, mode="constant"):
    """One semi-Lagrangian pull rho <- rho(x - u dt) with linear
    interpolation (move_density.py 2d:122-128, 3d:212-219), as
    map_coordinates(order=1, cval=0): per axis the lower index floor(c)
    with weight 1 - (c - floor c) and the upper one with c - floor c; in
    mode "constant" a corner outside the grid reads 0 on its own, in mode
    "nearest" indices clamp to the grid. The corners are summed in
    map_coordinates' order."""
    dim = d_grid.ndim
    n = d_grid.shape[0]
    pts = _index_grid(scene_size, n, dim, d_grid.device)
    back = pts - dt * vel_grid
    idx = (back - scene_size[0]) * n / (scene_size[1] - scene_size[0])
    nodes = []
    for i in range(dim):
        c = idx[..., i]
        lower = torch.floor(c)
        upper_w = c - lower
        lo = lower.to(torch.int64)
        nodes.append(((lo, 1 - upper_w), (lo + 1, upper_w)))
    flat_grid = d_grid.reshape(-1)
    out = None
    for corner in range(1 << dim):
        flat, weight, valid = 0, None, None
        for i in range(dim):
            index, w = nodes[i][(corner >> (dim - 1 - i)) & 1]
            inside = (index >= 0) & (index < n)
            valid = inside if valid is None else valid & inside
            weight = w if weight is None else weight * w
            flat = flat * n + torch.clamp(index, 0, n - 1)
        val = flat_grid[flat]
        if mode == "constant":
            val = torch.where(valid, val, 0.0)
        elif mode != "nearest":
            raise ValueError(f"advect_density: mode {mode!r}")
        term = weight * val
        out = term if out is None else out + term
    return out


def raw_velocity_grid(fluid, params, n):
    """Raw network velocity (no BCs) on the transport grid (2d:120), in
    chunks of CHUNK points."""
    pts = _index_grid(fluid.scene.scene_size, n, fluid.scene.dim,
                      params[0][0].device)
    flat = pts.reshape(-1, fluid.scene.dim)
    with torch.no_grad():
        vel = torch.cat([apply_siren(params, fluid.siren_cfg, x)
                         for x in flat.split(CHUNK)])
    return vel.reshape(pts.shape)


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


def transport_rollout(fluid, params_per_step, n=None, dt=None,
                      with_error=None, key=None):
    """Replay checkpoints: advect the density and, for taylorgreen, take
    each frame's velocity error (move_density.py 2d:116-152). 2D pulls
    every frame; 3D skips the pull at t = 0 (3d:212). `key` draws the
    initial density's jitter (init_density). Yields (t, d_grid, vel_grid,
    err)."""
    scene = fluid.scene
    n = n or (1000 if scene.dim == 2 else 200)
    dt = dt or scene.dt
    with_error = (scene.name == "taylorgreen") if with_error is None \
        else with_error
    mode = "constant" if scene.dim == 2 else "nearest"
    init = init_density(scene, n, key, fluid.device)
    d_grid = init[0] if isinstance(init, tuple) else init
    truth = taylor_green_truth(n) if with_error else None
    ss = scene.scene_size
    for t, params in enumerate(params_per_step):
        vel = raw_velocity_grid(fluid, params, n)
        if scene.dim == 2 or t > 0:
            d_grid = advect_density(d_grid, vel, ss, dt, mode)
        err = tg_velocity_error(vel, truth) if with_error else None
        yield t, d_grid, vel, err
