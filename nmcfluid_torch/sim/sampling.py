"""Training-point samplers and grid lookups (port of
nmcfluid/sim/sampling.py).

Grids use indexing='ij'. In scenes with obstacles `fluid_points` redraws
the points that fall inside one for a fixed number of rounds and returns
a validity mask, as the JAX package does. The samplers take a key or a
KeyGroup (utils/keys.py) of G keys; a group gives (G, n, dim) points, row
g those of its key g alone.
"""
import torch

from ..utils.keys import KeyGroup


def grid_resolutions(scene_size, resolution):
    """Aspect-scaled per-axis counts: the longest box edge gets
    `resolution` cells (model_utils.py 2d:4-7)."""
    dim = len(scene_size) // 2
    ext = [scene_size[2 * i + 1] - scene_size[2 * i] for i in range(dim)]
    m = max(ext)
    return tuple(max(1, int(round(resolution * e / m))) for e in ext)


def uniform_grid(scene_size, resolution, with_boundary=False, device="cpu"):
    """Cell-centered uniform grid over the scene box; with_boundary appends
    the box faces (model_utils.py 2d:9-20). Returns (res_x, res_y[, res_z],
    dim)."""
    dim = len(scene_size) // 2
    res = grid_resolutions(scene_size, resolution)
    axes = []
    for i in range(dim):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        a = (torch.arange(res[i], dtype=torch.float32, device=device)
             + 0.5) / res[i]
        if with_boundary:
            z = torch.zeros(1, device=device)
            a = torch.cat([z, a, z + 1.0])
        axes.append(lo + a * (hi - lo))
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def random_points(key, n, scene_size, device="cpu"):
    """Uniform random points in the scene box (model_utils.py 2d:22-31):
    (n, dim), or (G, n, dim) from a KeyGroup."""
    dim = len(scene_size) // 2
    u = key.uniform((n, dim), device)
    lo = torch.tensor([scene_size[2 * i] for i in range(dim)],
                      dtype=torch.float32, device=device)
    hi = torch.tensor([scene_size[2 * i + 1] for i in range(dim)],
                      dtype=torch.float32, device=device)
    return lo + u * (hi - lo)


def training_points(key, n, scene, pattern="random", resolution=None,
                    device="cpu"):
    """sample_in_training's three patterns (base.py:226-251): 'random',
    'uniform' (the cell-centered grid with the box faces) and
    'random+uniform' (half each). The grid is tiled and truncated to n
    points, as the JAX package keeps its shapes static. Returns (pts,
    valid), with the group's axis first from a KeyGroup."""
    if pattern == "random":
        return fluid_points(key, n, scene, device=device)
    if pattern not in ("uniform", "random+uniform"):
        raise ValueError(f"sample pattern {pattern!r}")
    grid = uniform_grid(scene.scene_size, resolution or
                        int(round(n ** (1.0 / scene.dim))),
                        with_boundary=True, device=device)
    grid = grid.reshape(-1, scene.dim)
    lead = (len(key),) if isinstance(key, KeyGroup) else ()

    def tiled(m):
        pts = grid.repeat(-(-m // grid.shape[0]), 1)[:m]
        return (pts.expand(lead + pts.shape),
                scene.fluid_mask(pts).expand(lead + (m,)))
    if pattern == "uniform":
        return tiled(n)
    half = n // 2
    r, rv = fluid_points(key, n - half, scene, device=device)
    g, gv = tiled(half)
    return torch.cat([r, g], -2), torch.cat([rv, gv], -1)


def fluid_points(key, n, scene, rounds: int = 8, device="cpu"):
    """Random points restricted to the fluid region by fixed-round
    rejection (sampling.py:79-101): round i draws the box with
    key.fold_in(i) and fills the slots still invalid. Returns (pts (n,
    dim), valid (n,) bool); slots still invalid after `rounds` rounds are
    flagged for a zero loss weight (the reference shrinks the batch
    instead, base.py:239-249). The rounds stop once every slot is valid,
    of every batch of a KeyGroup: a later round fills only the slots
    still invalid, so it changes nothing there."""
    if not scene.has_obstacle:
        pts = random_points(key, n, scene.scene_size, device)
        return pts, torch.ones(pts.shape[:-1], dtype=torch.bool,
                               device=device)
    pts = random_points(key.fold_in(0), n, scene.scene_size, device)
    valid = scene.fluid_mask(pts)
    for i in range(1, rounds):
        if bool(valid.all()):
            break
        cand = random_points(key.fold_in(i), n, scene.scene_size, device)
        cand_ok = scene.fluid_mask(cand)
        pts = torch.where((~valid & cand_ok)[..., None], cand, pts)
        valid = valid | cand_ok
    return pts, valid


def nearest_lookup(grid, scene_size, y):
    """Nearest-cell gather into a cell-centered grid over the scene box
    (demo/image.h:53-58 in 2D, demo/scene_3d.h:102-128 in 3D). grid:
    (res_x, res_y[, res_z]); y: (..., dim).
    Out-of-box queries clamp. The cast truncates toward zero, as the JAX
    package's astype(int32) does."""
    dim = y.shape[-1]
    res = grid.shape
    flat = None
    for i in range(dim):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        u = (y[..., i] - lo) / (hi - lo) * res[i]
        idx = torch.clamp(u.to(torch.int32), 0, res[i] - 1).to(torch.int64)
        flat = idx if flat is None else flat * res[i] + idx
    return grid.reshape(-1)[flat]


def bilinear_lookup(grid, scene_size, y):
    """Multilinear gather into a cell-centered grid over the scene box
    (the layout of nearest_lookup; clamped at the walls), where the
    deterministic projections need sub-cell accuracy."""
    dim = y.shape[-1]
    res = grid.shape
    i0s, ws = [], []
    for i in range(dim):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        u = (y[..., i] - lo) / (hi - lo) * res[i] - 0.5
        i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, res[i] - 2)
        i0s.append(i0)
        ws.append(torch.clamp(u - i0.to(u.dtype), 0.0, 1.0))
    flat_grid = grid.reshape(-1)
    out = torch.zeros(y.shape[:-1], dtype=grid.dtype, device=grid.device)
    for corner in range(1 << dim):
        flat = torch.zeros(y.shape[:-1], dtype=torch.int64, device=y.device)
        w = torch.ones(y.shape[:-1], dtype=grid.dtype, device=grid.device)
        for i in range(dim):
            hi_bit = (corner >> i) & 1
            flat = flat * res[i] + i0s[i] + hi_bit
            w = w * (ws[i] if hi_bit else 1.0 - ws[i])
        out = out + w * flat_grid[flat]
    return out
