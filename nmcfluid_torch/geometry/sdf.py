"""Analytic signed-distance functions of scene obstacles (port of
nmcfluid/geometry/sdf.py: the circle of the karman family, the sphere of
smoke_obs and karman3d's cylinder).

Convention of the reference: sdf > 0 in the fluid, < 0 inside the
obstacle.
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
