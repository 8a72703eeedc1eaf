"""Per-scene hard boundary conditions (port of models/boundary.py).

apply_boundary(scene, raw_vel, x, eps=...) -> vel, for the ported scenes:
  taylorgreen  a linear no-through-flow ramp on each of the four walls
               (src/2d/models/base.py:182-189);
  karman, karman2cyl, karman3cyl
               the inlet band clamped to u = karman_vel, the obstacle
               ramp off the scene's obstacle SDF (the min over its
               circles) and the y-wall ramp (base.py:169-180).
Other scenes raise. At fixed x each policy is affine in the raw velocity,
which the fused fit's (A, c) form relies on.
"""
import numpy as np
import torch

KARMAN_FAMILY = ("karman", "karman2cyl", "karman3cyl")


def wall_ramp(coord, lo, hi, eps):
    """min(|c-lo|, |c-hi|) clamped to [0, eps], / eps — the reference's
    linear no-through-flow ramp (base.py:176-177)."""
    return torch.minimum(torch.clamp(torch.abs(coord - lo), 0.0, eps),
                         torch.clamp(torch.abs(coord - hi), 0.0, eps)) / eps


def sdf_ramp(sdf_vals, eps):
    """clamp(d, 0, eps)/eps — no-slip ramp off an obstacle SDF
    (base.py:352-358, smoothstep_circular_obs)."""
    return torch.clamp(sdf_vals, 0.0, eps) / eps


def apply_boundary(scene, vel, x, *, eps, t=0):
    """Apply the scene's hard BCs to raw network output vel at points x."""
    ss = scene.scene_size
    if scene.name == "taylorgreen":
        u_w = wall_ramp(x[..., 0], ss[0], ss[1], eps)
        v_w = wall_ramp(x[..., 1], ss[2], ss[3], eps)
        return vel * torch.stack([u_w, v_w], dim=-1)
    if scene.name in KARMAN_FAMILY:
        # the band's edge in float32, as the JAX package adds a weak
        # Python float to its float32 eps
        edge = float(np.float32(ss[0]) + np.float32(eps))
        inlet = (x[..., 0] >= ss[0]) & (x[..., 0] <= edge)
        u = torch.where(inlet, scene.karman_vel, vel[..., 0])
        vel = torch.stack([u, vel[..., 1]], dim=-1)
        vel = vel * sdf_ramp(scene.obstacle_sdf(x), eps)[..., None]
        v_w = wall_ramp(x[..., 1], ss[2], ss[3], eps)
        return vel * torch.stack([torch.ones_like(v_w), v_w], dim=-1)
    raise NotImplementedError(
        f"apply_boundary: scene {scene.name!r} is not ported yet")
