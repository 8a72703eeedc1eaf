"""Analytic signed-distance functions of scene obstacles (port of
nmcfluid/geometry/sdf.py: the circle of the karman family, the sphere of
smoke_obs, karman3d's cylinder, and the J-pipe's walls and interior).

Convention of the reference: sdf > 0 in the fluid, < 0 inside the
obstacle (the J-pipe's wall distance is unsigned).
"""
import torch


def sqrt_rn(x):
    """float32 sqrt, correctly rounded on every device, as the JAX
    package's. CUDA's is; PyTorch's vectorized CPU sqrt is off by an ulp
    on ~0.7% of inputs (AVX-512 build), and the karman ramps (1/eps) and
    circle normals (1/r) scale an ulp up past 1e-6."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def circle(center, radius):
    cx, cy = float(center[0]), float(center[1])
    r = float(radius)

    def f(x):
        return sqrt_rn((x[..., 0] - cx) ** 2 + (x[..., 1] - cy) ** 2) - r
    return f


def dist_to(x, center):
    """|x - center| over the last axis, correctly rounded (sqrt_rn)."""
    return sqrt_rn(sum((x[..., i] - c) ** 2 for i, c in enumerate(center)))


def sphere(center, radius):
    c = tuple(float(v) for v in center)
    r = float(radius)

    def f(x):
        return dist_to(x, c) - r
    return f


def cylinder_xz(center_xz, radius):
    """Infinite cylinder along y: distance in the (x, z) plane
    (src/3d/sources.py:141-145)."""
    cx, cz = float(center_xz[0]), float(center_xz[1])
    r = float(radius)

    def f(x):
        return sqrt_rn((x[..., 0] - cx) ** 2 + (x[..., 2] - cz) ** 2) - r
    return f


def jpipe_walls():
    """Unsigned distance to the J-pipe walls (src/2d/sources.py:87-100):
    the horizontal run [0, 1] x [0, 0.5], the vertical run [1.5, 2] x
    [1, 2] and the quarter-annulus elbow around (1, 1) of radii 0.5 and
    1."""
    def f(x):
        px, py = x[..., 0], x[..., 1]
        m1 = (px >= 0.0) & (px <= 1.0)
        m2 = (py >= 1.0) & (py <= 2.0)
        d1 = torch.minimum(torch.abs(py - 0.5), torch.abs(py))
        d2 = torch.minimum(torch.abs(px - 1.5), torch.abs(px - 2.0))
        rr = sqrt_rn((px - 1.0) ** 2 + (py - 1.0) ** 2)
        d3 = torch.minimum(torch.abs(rr - 0.5), torch.abs(rr - 1.0))
        return torch.where(m1, d1, torch.where(m2, d2, d3))
    return f


def jpipe_interior_mask():
    """True inside the J-pipe (base.py:218-222)."""
    def f(x):
        px, py = x[..., 0], x[..., 1]
        d = sqrt_rn((px - 1.0) ** 2 + (py - 1.0) ** 2)
        m1 = (px >= 0.0) & (px <= 1.0) & (py >= 0.0) & (py <= 0.5)
        m2 = (px >= 1.5) & (px <= 2.0) & (py >= 1.0) & (py <= 2.0)
        m3 = (d >= 0.5) & (d <= 1.0) & (px >= 1.0) & (py <= 1.0)
        return m1 | m2 | m3
    return f
