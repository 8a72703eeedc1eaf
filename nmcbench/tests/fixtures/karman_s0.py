"""Plain reference of a configuration that is not a box, for the test that
a configuration is added as files alone: karman's channel (walls at the
two y ends, open inlet and outlet) around one circle, with the screening
sigma set to 0 so that the program's spectral solve is the box's with no
modal correction (Neural-Monte-Carlo-Fluid-Simulation
src/2d/models/base.py:169-180): the inlet band set to the inflow speed,
the velocity ramped off the circle grown by the mask distance, the y
component ramped off the y walls."""
import numpy as np
import torch

from nmcbench.reference import box
from nmcbench.reference.box import clamp_back, pressure  # noqa: F401

BAND = 1e-6


def _circle(x, cfg):
    c = cfg["scene_fields"]["obstacle_center"]
    return torch.sqrt((x[..., 0] - c[0]) ** 2 + (x[..., 1] - c[1]) ** 2)


def _grown_sdf(x, cfg):
    sf = cfg["scene_fields"]
    return _circle(x, cfg) - (sf["obstacle_radius"]
                              + sf["boundary_distance_mask"])


def affine(x, cfg, eps, t):
    """(A, c, drawn): u = A raw + c at x; `drawn` marks the points within
    BAND of the inlet band's edge, where float32 may decide either way."""
    sf = cfg["scene_fields"]
    lo = sf["scene_size"][0]
    edge = float(np.float32(lo) + np.float32(eps))
    inlet = (x[..., 0] >= lo) & (x[..., 0] <= edge)
    s = torch.clamp(_grown_sdf(x, cfg), 0.0, eps) / eps
    wy = box.ramps(x, sf["scene_size"], eps)[..., 1]
    A = torch.diag_embed(torch.stack([torch.where(inlet, 0.0, s), s * wy],
                                     dim=-1))
    c = torch.stack([torch.where(inlet, sf["karman_vel"] * s, 0.0),
                     torch.zeros_like(s)], dim=-1)
    return A, c, torch.abs(x[..., 0] - edge) < BAND


def fluid_mask(x, cfg):
    d = _grown_sdf(x, cfg)
    return d > 0.0, torch.abs(d) < BAND


def wall_distance(x, cfg):
    """Distance to the y walls and the circle (the inlet and outlet are
    open); outside is past a y wall or inside the circle."""
    sf = cfg["scene_fields"]
    _, _, y0, y1 = sf["scene_size"]
    dc = _circle(x, cfg)
    d = torch.minimum(torch.minimum(torch.abs(x[..., 1] - y0),
                                    torch.abs(y1 - x[..., 1])),
                      torch.abs(dc - sf["obstacle_radius"]))
    outside = (x[..., 1] < y0) | (x[..., 1] > y1) \
        | (dc < sf["obstacle_radius"])
    return d, outside
