"""Plain reference of the taylorgreen configuration: the closed square,
each velocity component ramped to zero on its own axis's walls
(Neural-Monte-Carlo-Fluid-Simulation src/2d/models/base.py:182-189). The
boundary conditions draw nothing; the rest of the geometry is the box's
(reference/box.py)."""
import torch

from nmcbench.reference import box
from nmcbench.reference.box import (clamp_back, fluid_mask,  # noqa: F401
                                    pressure, wall_distance)


def affine(x, cfg, eps, t):
    """(A (..., D, D), c (..., D), drawn (...)): u = A raw + c at x;
    `drawn` marks points whose value the program draws at random (none)."""
    A = torch.diag_embed(box.ramps(x, cfg["scene_fields"]["scene_size"], eps))
    c = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    return A, c, torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
