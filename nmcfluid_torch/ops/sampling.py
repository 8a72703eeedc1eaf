"""Uniform direction sampling on S^1 and S^2 (port of
nmcfluid/ops/sampling.py, the parts the walk uses)."""
import math

import torch


def unit_sphere_from_u(u, dim: int):
    """Map uniforms u[..., dim-1] to uniform directions on S^{dim-1}
    (sampleUnitSphereUniform<2|3>): 2D takes the angle 2*pi*u0; 3D takes
    z = 1 - 2*u0 and the azimuth 2*pi*u1."""
    if dim == 2:
        phi = 2.0 * math.pi * u[..., 0]
        return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def pdf_unit_sphere(dim: int):
    return 1.0 / (2.0 * math.pi) if dim == 2 else 1.0 / (4.0 * math.pi)
