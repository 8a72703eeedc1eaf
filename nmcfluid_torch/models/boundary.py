"""Per-scene hard boundary conditions (port of models/boundary.py).

apply_boundary(scene, raw_vel, x, eps=...) -> vel. Only the Taylor-Green
policy is ported: a linear no-through-flow ramp on each of the four walls
(src/2d/models/base.py:182-189). Other scenes raise.
"""
import torch


def wall_ramp(coord, lo, hi, eps):
    """min(|c-lo|, |c-hi|) clamped to [0, eps], / eps — the reference's
    linear no-through-flow ramp (base.py:176-177)."""
    return torch.minimum(torch.clamp(torch.abs(coord - lo), 0.0, eps),
                         torch.clamp(torch.abs(coord - hi), 0.0, eps)) / eps


def apply_boundary(scene, vel, x, *, eps, t=0):
    """Apply the scene's hard BCs to raw network output vel at points x."""
    if scene.name != "taylorgreen":
        raise NotImplementedError(
            f"apply_boundary: scene {scene.name!r} is not ported yet "
            "(only 'taylorgreen')")
    ss = scene.scene_size
    u_w = wall_ramp(x[..., 0], ss[0], ss[1], eps)
    v_w = wall_ramp(x[..., 1], ss[2], ss[3], eps)
    return vel * torch.stack([u_w, v_w], dim=-1)
