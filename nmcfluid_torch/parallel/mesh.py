"""The points mesh: walk the pressure solve's points on several devices
(port of nmcfluid/parallel/mesh.py).

Every per-point walk is independent (walk_on_stars.h:91-104), so the
solve needs no communication between devices. Where the JAX package lays
the point axis out over a jax Mesh, a mesh here is a plain list of torch
devices, and the fluid hands each device one contiguous block of whole
pressure chunks (`shard_bounds` over the chunks; sim/fluid.py), so that
each chunk walks exactly as without a mesh. `shard_points` cuts a point
axis into one contiguous slice a device and moves each there, `replicate`
copies the small tensors (the network's parameters, the divergence grid)
to every device. The same device may appear more than once (["cpu",
"cpu"], ["cuda:0", "cuda:0"]), which exercises the split on one device.
"""
import torch


def points_mesh(n_devices=None, devices=None):
    """A list of torch devices: `devices` as given, else the first
    n_devices CUDA devices (all of them when None). Raises RuntimeError
    when more CUDA devices are asked for than exist, or none exist."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise RuntimeError(f"points_mesh: {n} CUDA devices asked for, "
                           f"{have} present")
    return [torch.device("cuda", i) for i in range(n)]


def shard_bounds(n, mesh):
    """[(start, stop), ...]: one contiguous slice of n items (points or
    chunks) a device, in order, their sizes differing by one at most."""
    m = len(mesh)
    return [(k * n // m, (k + 1) * n // m) for k in range(m)]


def shard_points(mesh, arr):
    """Cut the leading (point) axis into one contiguous slice a device
    (`shard_bounds`), each moved to its device."""
    return [arr[a:b].to(dev) for (a, b), dev in
            zip(shard_bounds(arr.shape[0], mesh), mesh)]


def replicate(mesh, tree):
    """One copy of a nested list/tuple of tensors (network parameters)
    on each device of the mesh; other leaves are passed through."""
    def to(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, (list, tuple)):
            return type(x)(to(v, dev) for v in x)
        return x
    return [to(tree, dev) for dev in mesh]
