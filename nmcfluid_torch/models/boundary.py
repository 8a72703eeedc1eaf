"""Per-scene hard boundary conditions (port of models/boundary.py).

apply_boundary(scene, raw_vel, x, eps=..., t=..., key=...) -> vel, for the
ported scenes:
  taylorgreen  a linear no-through-flow ramp on each of the four walls
               (src/2d/models/base.py:182-189);
  karman, karman2cyl, karman3cyl
               the inlet band clamped to u = karman_vel, the obstacle
               ramp off the scene's obstacle SDF (the min over its
               circles) and the y-wall ramp (base.py:169-180);
  jpipe        the inlet clamped to u = karman_vel, the elbow's normal
               component scaled by the wall distance, per-arm wall ramps
               and zero outside the pipe (base.py:191-222);
  smoke        the jet sphere set to w = 0.2 plus time-seeded jitter, and
               the six-wall ramp (3d/base.py:199-222);
  smoke_obs    the jet sphere set to w = 1, the sphere obstacle's ramp and
               the six-wall ramp (3d/base.py:224-245);
  vortex_collide  the six-wall ramp (3d/base.py:246-256);
  karman3d     the inlet z-band set to w = karman_vel, the cylinder's ramp
               and the x- and y-wall ramps (3d/base.py:258-274).
Other scenes raise. At fixed x each policy is affine in the raw velocity,
which the fused fit's (A, c) form relies on.
"""
import numpy as np
import torch

from ..geometry.sdf import (dist_to, jpipe_interior_mask, jpipe_walls,
                            sqrt_rn)

KARMAN_FAMILY = ("karman", "karman2cyl", "karman3cyl")
JET_CENTER = (0.0, 0.0, -0.6)          # 3d/base.py:201


def wall_ramp(coord, lo, hi, eps):
    """min(|c-lo|, |c-hi|) clamped to [0, eps], / eps — the reference's
    linear no-through-flow ramp (base.py:176-177)."""
    return torch.minimum(torch.clamp(torch.abs(coord - lo), 0.0, eps),
                         torch.clamp(torch.abs(coord - hi), 0.0, eps)) / eps


def sdf_ramp(sdf_vals, eps):
    """clamp(d, 0, eps)/eps — no-slip ramp off an obstacle SDF
    (base.py:352-358, smoothstep_circular_obs)."""
    return torch.clamp(sdf_vals, 0.0, eps) / eps


def _band_edge(lo, eps):
    """lo + eps in float32, as the JAX package adds a weak Python float to
    its float32 eps."""
    return float(np.float32(lo) + np.float32(eps))


def _box_ramps(x, ss, eps, axes):
    """Per-component wall ramps on `axes`, 1 on the other components."""
    return torch.stack([wall_ramp(x[..., i], ss[2 * i], ss[2 * i + 1], eps)
                        if i in axes else torch.ones_like(x[..., 0])
                        for i in range(x.shape[-1])], dim=-1)


def _jpipe(scene, vel, x, eps):
    """The J-pipe policy (base.py:191-222). In the elbow (neither arm)
    the radial component about (1, 1) is scaled by the wall distance, so
    the affine map's A is not diagonal there."""
    px, py = x[..., 0], x[..., 1]
    inlet = (px >= 0.0) & (px <= 0.1) & (py >= 0.0) & (py <= 0.5)
    u = torch.where(inlet, scene.karman_vel, vel[..., 0])
    vel = torch.stack([u, vel[..., 1]], dim=-1)
    m1 = (px >= 0.0) & (px <= 1.0)
    m2 = (py >= 1.0) & (py <= 2.0)
    corner = ~m1 & ~m2
    n = x - 1.0
    n = n / torch.clamp(sqrt_rn(torch.sum(n * n, -1, keepdim=True)),
                        min=1e-12)
    u_n = torch.sum(n * vel, -1, keepdim=True) * n
    bent = (vel - u_n) + jpipe_walls()(x)[..., None] * u_n
    vel = torch.where(corner[..., None], bent, vel)
    v_w = torch.where(m1, wall_ramp(py, 0.0, 0.5, eps), 1.0)
    u_w = torch.where(m2, wall_ramp(px, 1.5, 2.0, eps), 1.0)
    vel = vel * torch.stack([u_w, v_w], dim=-1)
    return torch.where(jpipe_interior_mask()(x)[..., None], vel, 0.0)


def apply_boundary(scene, vel, x, *, eps, t=0, key=None, group_dims=0):
    """Apply the scene's hard BCs to raw network output vel at points x.
    `key` (a key object, utils/keys.py) seeds smoke's jet jitter, folded
    with the timestep t; the other scenes draw nothing. The first
    `group_dims` axes of x index the batches of a pool group: the jitter
    is drawn once at the shape of one batch and broadcast over them, as
    the JAX package's draw under vmap."""
    ss = scene.scene_size
    name = scene.name
    if name == "taylorgreen":
        return vel * _box_ramps(x, ss, eps, (0, 1))
    if name in KARMAN_FAMILY:
        inlet = (x[..., 0] >= ss[0]) & (x[..., 0] <= _band_edge(ss[0], eps))
        u = torch.where(inlet, scene.karman_vel, vel[..., 0])
        vel = torch.stack([u, vel[..., 1]], dim=-1)
        vel = vel * sdf_ramp(scene.obstacle_sdf(x), eps)[..., None]
        return vel * _box_ramps(x, ss, eps, (1,))
    if name == "jpipe":
        return _jpipe(scene, vel, x, eps)
    if name in ("smoke", "smoke_obs"):
        in_jet = dist_to(x, JET_CENTER) < 0.1
        if name == "smoke":
            # the reference re-seeds numpy with the timestep
            # (3d/base.py:205-210); here one draw a point from the
            # timestep-folded key, as the JAX package does
            u = key.fold_in(t).uniform(x.shape[group_dims:-1], x.device)
            r = 10.0 * (2.0 * u - 1.0)
            jet = torch.stack([0.01 * r, 0.01 * r, 0.2 + 0.01 * r], dim=-1)
            vel = torch.where(in_jet[..., None], jet, vel)
        else:
            w = torch.where(in_jet, 1.0, vel[..., 2])
            vel = torch.cat([vel[..., :2], w[..., None]], dim=-1)
            vel = vel * sdf_ramp(scene.obstacle_sdf(x), eps)[..., None]
        return vel * _box_ramps(x, ss, eps, (0, 1, 2))
    if name == "vortex_collide":
        return vel * _box_ramps(x, ss, eps, (0, 1, 2))
    if name == "karman3d":
        inlet = (x[..., 2] >= ss[4]) & (x[..., 2] <= _band_edge(ss[4], eps))
        w = torch.where(inlet, scene.karman_vel, vel[..., 2])
        vel = torch.cat([vel[..., :2], w[..., None]], dim=-1)
        vel = vel * sdf_ramp(scene.obstacle_sdf(x), eps)[..., None]
        return vel * _box_ramps(x, ss, eps, (0, 1))
    raise NotImplementedError(f"apply_boundary: unknown scene {name!r}")
