"""Unit-circle direction sampling (port of nmcfluid/ops/sampling.py, 2D)."""
import math

import torch


def unit_sphere_from_u(u, dim: int):
    """Map uniforms u[..., dim-1] to uniform directions on S^{dim-1}
    (sampleUnitSphereUniform<2>: angle 2*pi*u0)."""
    if dim != 2:
        raise NotImplementedError("unit_sphere_from_u: only 2D is ported")
    phi = 2.0 * math.pi * u[..., 0]
    return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


def pdf_unit_sphere(dim: int):
    if dim != 2:
        raise NotImplementedError("pdf_unit_sphere: only 2D is ported")
    return 1.0 / (2.0 * math.pi)
