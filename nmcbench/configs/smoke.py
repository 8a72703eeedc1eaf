"""Plain reference of the smoke configuration: the closed cube, each
velocity component ramped to zero on its own axis's walls, and the jet
sphere of radius 0.1 at (0, 0, -0.6) set to the jet's velocity
(Neural-Monte-Carlo-Fluid-Simulation src/3d/models/base.py:199-222).
The jet's jitter is drawn at random a point, so inside the sphere (and
within 1e-5 of its surface, where float32 may classify a point either
way) the value is marked as drawn: the reference knows there only that
the network does not matter (A = 0). The rest of the geometry is the
box's (reference/box.py)."""
import torch

from nmcbench.reference import box
from nmcbench.reference.box import (clamp_back, fluid_mask,  # noqa: F401
                                    pressure, wall_distance)

JET_CENTER = (0.0, 0.0, -0.6)
JET_RADIUS = 0.1
BAND = 1e-5


def affine(x, cfg, eps, t):
    """(A (..., 3, 3), c (..., 3), drawn (...)): u = A raw + c at x."""
    ctr = torch.tensor(JET_CENTER, dtype=x.dtype, device=x.device)
    r = torch.linalg.vector_norm(x - ctr, dim=-1)
    in_jet = r < JET_RADIUS
    ramp = box.ramps(x, cfg["scene_fields"]["scene_size"], eps)
    A = torch.diag_embed(torch.where(in_jet[..., None], 0.0, ramp))
    c = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    return A, c, r < JET_RADIUS + BAND
