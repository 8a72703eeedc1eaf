"""Per-point preamble and first-step draws of the WoSt gradient estimator
(the parts of nmcfluid/wost/pool.py that the generation executor uses).

The compacted walker-pool executor itself is not ported yet.
"""
from typing import NamedTuple

import math

import torch

from ..ops import fastrand
from ..ops.sampling import pdf_unit_sphere, unit_sphere_from_u
from .solver import RADIUS_SHRINK, _dirichlet_dist

# fastrand salts for the first-sample streams (the walk steps use salts
# 0-5 on their own seed; these run on an independent seed)
_SALT_JIT_S = 8    # source-direction stratum jitter (+1 = 2nd axis in 3D)
_SALT_U2A, _SALT_U2B = 10, 11   # in-ball radius uniforms
_SALT_JIT_B = 12   # boundary-direction stratum jitter (+1 in 3D)


class PointData(NamedTuple):
    """Per-evaluation-point precomputes (N,) unless noted."""
    pts: torch.Tensor         # (N, D)
    R1: torch.Tensor          # first ball radius (walk_on_stars.h:486)
    ball1: object             # greens2d.Ball or greens3d.Ball, (N,) fields
    degenerate: torch.Tensor  # bool: on/next to the boundary
    rot: torch.Tensor         # (N, D-1) Cranley-Patterson rotation
    norm1: torch.Tensor       # first-ball source norm
    thr1: torch.Tensor        # first-ball throughput
    bgd: torch.Tensor         # boundaryGradientDirection coefficient


def _first_greens(scene, settings):
    """Green's fn of the FIRST ball. A delayed Tikhonov start would make
    it harmonic; that setting is rejected by solver.check_supported."""
    return scene.greens()


def _precompute(scene, settings, pts, key):
    q = scene.qmod()
    D = scene.dim
    g1 = _first_greens(scene, settings)
    nd = q.distance(scene.neumann, pts)
    dd = _dirichlet_dist(scene, pts)
    R1 = RADIUS_SHRINK * torch.minimum(nd, dd)
    degenerate = R1 <= 1e-6
    R1 = torch.clamp(R1, min=1e-6)
    ball1 = g1.make_ball(R1)
    rot = key.fold_in(0xC0FFEE).uniform((pts.shape[0], D - 1), pts.device)
    return PointData(
        pts=pts, R1=R1, ball1=ball1, degenerate=degenerate, rot=rot,
        norm1=g1.norm(ball1), thr1=g1.pk_over_uniform(ball1),
        bgd=g1.pk_grad_over_thr(ball1) * R1 / pdf_unit_sphere(D))


def _strat_dir(seed2, w, i, salt, rot_i, shift, n_pairs, D):
    """First-step direction for pair w at point i: stratified over the
    pair index with counter-based jitter + per-point rotation (the role
    of walk_on_stars.h:489-491). w, i: int64 tensors broadcasting
    together; rot_i broadcasts against them with a trailing (D-1). In 3D
    the pairs stratify a near-square grid of a = ceil(sqrt(n_pairs))
    columns and ceil(n_pairs / a) rows, jittered at salts `salt` and
    `salt + 1`."""
    if D == 2:
        jit = fastrand.uniform(seed2, w, salt, i)
        u = torch.remainder((w.to(torch.float32) + jit) / n_pairs
                            + rot_i[..., 0] + shift, 1.0)
        return unit_sphere_from_u(u[..., None], 2)
    a = int(math.ceil(math.sqrt(n_pairs)))
    b = (n_pairs + a - 1) // a
    j0 = fastrand.uniform(seed2, w, salt, i)
    j1 = fastrand.uniform(seed2, w, salt + 1, i)
    u0 = torch.remainder((torch.remainder(w, a).to(torch.float32) + j0) / a
                         + rot_i[..., 0] + shift, 1.0)
    u1 = torch.remainder((torch.div(w, a, rounding_mode="floor")
                          .to(torch.float32) + j1) / b
                         + rot_i[..., 1] + shift, 1.0)
    return unit_sphere_from_u(torch.stack([u0, u1], dim=-1), 3)
