"""Compacted walker-pool executor of the WoSt gradient estimator, and the
per-point preamble and first-step draws it shares with the generation
executor (port of nmcfluid/wost/pool.py).

Walks are drawn from a global work queue into a fixed pool of S slots.
Every `pool_refill_every` steps terminated lanes scatter their
contribution into per-point running sums (one index_add_) and their
slots are refilled from the queue (prefix-sum slot assignment), so the
work tracks the sum of walk lengths (walk_on_stars.h:91-104). A lane id g
enumerates (pair, antithetic half, point); its start state is regenerated
from counter streams keyed on (pair, point), and its continuation draws
on (its own step count, pair * N + point): the generation executor's
streams (wost/gen.py), so the two executors walk the same walks and
agree to reduction order when the control-variate warmup is a multiple
of gen_group_pairs.

The JAX package drains the pool in an in-graph while loop; here each trip
(scatter + refill, then `pool_refill_every` steps) is eager PyTorch and
the host reads one flag a trip to stop.

Adaptive walk allocation (adaptive_walks = kappa > 0, pool.py:385-466):
after the warmup, geometric rounds of pairs up to n_pairs; every point
takes the first round, and before each later one a point stays alive
while its optimal-allocation target, kappa * n_pairs * sigma_i *
mean(sigma) / mean(sigma^2) for the larger of the solution's and the
gradient's sigma (from the accumulator's second moments, on the host),
exceeds the pairs it has had. A round's queue enumerates (pair, half,
alive slot j), and slot j walks the real point active_idx[j] on that
point's own streams, so an adaptive run draws the same walks as a fixed
run for the pairs it issues. The JAX package measured it as a negative
on karman (PARITY.md:652); it stays default-off.
"""
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fastrand
from ..ops.sampling import pdf_unit_sphere, unit_sphere_from_u
from .solver import (ACTIVE, DONE_DIRICHLET, DONE_RR, RADIUS_SHRINK,
                     WalkSettings, WalkState, WostScene, _advance,
                     _dirichlet_dist, _fresh_state, _harmonic,
                     has_terminal, terminal_values)

EMPTY = -1  # slot status: no walk assigned (distinct from ACTIVE/terminal)

# fastrand salts for the first-sample streams (the walk steps use salts
# 0-8 on their own seed; these run on an independent seed)
_SALT_JIT_S = 8    # source-direction stratum jitter (+1 = 2nd axis in 3D)
_SALT_U2A, _SALT_U2B = 10, 11   # in-ball radius uniforms
_SALT_JIT_B = 12   # boundary-direction stratum jitter (+1 in 3D)

# pool counts since the caller last zeroed them: drains run, trips
# (scatter + refill, then pool_refill_every steps), steps advanced, the
# seconds spent draining, and the adaptive rounds run with the points
# alive in them summed over the rounds (their share: alive / (rounds *
# N)); read by chip_smoke.py
counts = {"drains": 0, "trips": 0, "steps": 0, "seconds": 0.0,
          "rounds": 0, "alive": 0}


class PointData(NamedTuple):
    """Per-evaluation-point precomputes (N,) unless noted. `packed` holds
    every per-point field a refill reads as one (N, K) row matrix, so a
    refill gathers one row a lane: [pts (D) | rot (D-1) | R1 | norm1 |
    thr1 | bgd | degenerate | ball leaves]."""
    pts: torch.Tensor         # (N, D)
    R1: torch.Tensor          # first ball radius (walk_on_stars.h:486)
    ball1: object             # greens2d.Ball or greens3d.Ball, (N,) fields
    degenerate: torch.Tensor  # bool: on/next to the boundary
    rot: torch.Tensor         # (N, D-1) Cranley-Patterson rotation
    norm1: torch.Tensor       # first-ball source norm
    thr1: torch.Tensor        # first-ball throughput
    bgd: torch.Tensor         # boundaryGradientDirection coefficient
    packed: torch.Tensor      # (N, K)


class PoolCarry(NamedTuple):
    next_lane: int            # next queue index not yet issued
    st: WalkState             # (S,) walker lanes
    g: torch.Tensor           # (S,) int64 lane id (stale when EMPTY)
    ok: torch.Tensor          # (S,) 1.0 unless the lane's point is degenerate
    first_src: torch.Tensor   # (S,) first ball source sample
    bgd_vec: torch.Tensor     # (S, D) signed boundaryGradientDirection
    sgd_vec: torch.Tensor     # (S, D) signed sourceGradientDirection
    acc: torch.Tensor         # (N, 3 + D) running sums:
    # [sum_sol | sum_first | n_valid | sum_grad (D)], and with adaptive
    # allocation (N, 4 + 2D), JAX's layout: [... | sum_grad^2 (D) |
    # sum_sol^2]


def _first_greens(scene, settings):
    """Green's function of the FIRST ball: harmonic while Tikhonov is
    delayed (steps_before_tikhonov > 0)."""
    if scene.absorption > 0.0 and settings.steps_before_tikhonov > 0:
        return _harmonic(scene.dim)
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
    norm1 = g1.norm(ball1)
    thr1 = g1.pk_over_uniform(ball1)
    bgd = g1.pk_grad_over_thr(ball1) * R1 / pdf_unit_sphere(D)
    cols = [pts, rot, R1[:, None], norm1[:, None], thr1[:, None],
            bgd[:, None], degenerate.to(torch.float32)[:, None]]
    cols += [leaf[:, None] for leaf in ball1]
    return PointData(pts=pts, R1=R1, ball1=ball1, degenerate=degenerate,
                     rot=rot, norm1=norm1, thr1=thr1, bgd=bgd,
                     packed=torch.cat(cols, dim=1))


def _unpack_row(row, D, ball_type):
    """Split packed (S, K) rows back into the per-lane fields."""
    pts = row[:, 0:D]
    rot = row[:, D:2 * D - 1]
    R1, norm1, thr1, bgd, degen = (row[:, 2 * D - 1 + j] for j in range(5))
    n_leaves = len(ball_type._fields)
    ball = ball_type(*(row[:, 2 * D + 4 + j] for j in range(n_leaves)))
    return pts, rot, R1, norm1, thr1, bgd, degen, ball


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


def _decode(g, n_anti, n_active, active_idx=None):
    """Lane id -> (pair w, antithetic half a, point i, sign): the queue
    enumerates (pair, half, slot j), slot fastest; slot j is the point
    active_idx[j], or j itself when active_idx is None (every run but an
    adaptive round: the decode stays integer arithmetic)."""
    j = torch.remainder(g, n_active)
    wa = torch.div(g, n_active, rounding_mode="floor")
    a = torch.remainder(wa, n_anti)
    w = torch.div(wa, n_anti, rounding_mode="floor")
    i = j if active_idx is None else active_idx[j]
    sign = 1.0 - 2.0 * a.to(torch.float32)
    return w, a, i, sign


def _start_states(scene, settings, pd: PointData, seed2, g, source_args,
                  n_pairs, n_anti, n_active, active_idx):
    """Start states for lane ids g (S,): the first-ball antithetic source
    sample and the first step to the ball's surface, regenerated from
    counter streams keyed on (pair, point); the per-point data arrives
    through one packed row gather."""
    D = scene.dim
    g1 = _first_greens(scene, settings)
    w, _, i, sign = _decode(g, n_anti, n_active, active_idx)
    row = pd.packed[i]                                 # (S, K), one gather
    pts_i, rot_i, R1_i, norm1_i, thr1_i, bgd_i, degen_i, ball_i = \
        _unpack_row(row, D, type(pd.ball1))

    if settings.ignore_source:
        first_src = torch.zeros(g.shape, dtype=torch.float32,
                                device=g.device)
        sgd_vec = torch.zeros(g.shape + (D,), dtype=torch.float32,
                              device=g.device)
    else:
        dir_s = _strat_dir(seed2, w, i, _SALT_JIT_S, rot_i, 0.0, n_pairs, D)
        u2 = torch.stack([fastrand.uniform(seed2, w, _SALT_U2A, i),
                          fastrand.uniform(seed2, w, _SALT_U2B, i)], dim=-1)
        r_s, _ = g1.sample_radius_u(ball_i, u2)
        y_vol = pts_i + (sign * r_s)[..., None] * dir_s
        first_src = norm1_i * scene.source_fn(y_vol, *source_args)
        # sourceGradientDirection, as the e^{-z}-free joint ratio
        sgd_vec = (sign * r_s * g1.grad_norm_over_eval(ball_i, r_s)
                   )[..., None] * dir_s

    dir_b = _strat_dir(seed2, w, i, _SALT_JIT_B, rot_i, 0.5, n_pairs, D)
    bgd_vec = (sign * bgd_i)[..., None] * dir_b
    x0 = pts_i + (sign * R1_i)[..., None] * dir_b
    st = _fresh_state(x0, thr=thr1_i, acc=first_src)
    return st, 1.0 - degen_i, first_src, bgd_vec, sgd_vec


def _scatter_refill(scene, settings, pd: PointData, seed2, g_hi, cv,
                    carry: PoolCarry, source_args, n_pairs, n_anti,
                    n_active, active_idx):
    """Terminated lanes fold their contributions into the per-point sums
    (one index_add_; with the second moments when acc has JAX's adaptive
    layout); freed slots take the next queued lane ids (prefix-sum
    ranks). `cv` is (N, 2): [cv_b | cv_s]. Returns the new carry and
    whether the queue is empty and every slot EMPTY."""
    st = carry.st
    term = (st.status != ACTIVE) & (st.status != EMPTY)
    _, _, i, _ = _decode(carry.g, n_anti, n_active, active_idx)

    total = st.acc
    if has_terminal(scene, settings):
        total = total + st.thr * terminal_values(scene, settings, st.x,
                                                 st.status)
    valid = (term & ((st.status == DONE_RR) | (st.status == DONE_DIRICHLET))
             & (carry.ok > 0.5))

    cv_i = cv[i]                                       # (S, 2), one gather
    bc = total - carry.first_src       # the boundary (continuation) part
    gvec = ((bc - cv_i[:, 0])[..., None] * carry.bgd_vec
            + (carry.first_src - cv_i[:, 1])[..., None] * carry.sgd_vec)
    vf = valid.to(torch.float32)
    cols = [(vf * total)[:, None], (vf * carry.first_src)[:, None],
            vf[:, None], vf[:, None] * gvec]
    if carry.acc.shape[1] > 3 + gvec.shape[1]:
        cols += [vf[:, None] * gvec * gvec, (vf * total * total)[:, None]]
    contrib = torch.cat(cols, dim=1)
    acc = carry.acc.index_add(0, i, contrib)

    # ---- refill the freed slots from the queue
    free = term | (st.status == EMPTY)
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    new_g = carry.next_lane + rank
    take = free & (new_g < g_hi)
    st_new, ok_new, fs_new, bv_new, sv_new = _start_states(
        scene, settings, pd, seed2, torch.where(take, new_g, 0), source_args,
        n_pairs, n_anti, n_active, active_idx)

    keep_status = torch.where(term, EMPTY, st.status)
    t1 = take[:, None]
    st2 = WalkState(*(torch.where(t1 if o.dim() == 2 else take, n, o)
                      for n, o in zip(st_new, st)))
    st2 = st2._replace(status=torch.where(take, ACTIVE, keep_status))
    n_free = int(free.sum())
    n_issued = max(0, min(n_free, g_hi - carry.next_lane))
    next_lane = carry.next_lane + n_issued
    # every slot was free and none was refilled: the queue is drained
    done = n_free == free.numel() and n_issued == 0
    return PoolCarry(
        next_lane=next_lane, st=st2, g=torch.where(take, new_g, carry.g),
        ok=torch.where(take, ok_new, carry.ok),
        first_src=torch.where(take, fs_new, carry.first_src),
        bgd_vec=torch.where(t1, bv_new, carry.bgd_vec),
        sgd_vec=torch.where(t1, sv_new, carry.sgd_vec),
        acc=acc), done


def _make_draw(seed_w, st, pl):
    """Continuation draws keyed on (per-lane step count, pair-lane id):
    the same streams for both antithetic halves."""
    steps = st.steps

    def draw(salt, shape):
        return fastrand.uniform(seed_w, steps, salt, pl).expand(shape)
    return draw


def _pool_launch(scene, settings, n_pairs, n_anti, N, pd, seeds, g_hi, cv,
                 carry: PoolCarry, source_args, max_trips, n_active,
                 active_idx):
    """Drain the queue up to g_hi: trips of [scatter + refill, then
    pool_refill_every walk steps] until the queue is empty and every slot
    EMPTY (pool.py:554-593). Returns the drained carry."""
    greens = scene.greens()
    seed_w, seed2 = seeds
    K = max(1, settings.pool_refill_every)
    for _ in range(max_trips):
        counts["trips"] += 1
        carry, done = _scatter_refill(scene, settings, pd, seed2, g_hi, cv,
                                      carry, source_args, n_pairs, n_anti,
                                      n_active, active_idx)
        if done:
            return carry
        # stream ids from the real (pair, point)
        w_, _, i_, _ = _decode(carry.g, n_anti, n_active, active_idx)
        pl = w_ * N + i_
        st = carry.st
        for _ in range(K):
            counts["steps"] += 1
            st = _advance(scene, greens, settings, st,
                          _make_draw(seed_w, st, pl), source_args,
                          step_cap=settings.pool_step_cap)
        carry = carry._replace(st=st)
    raise RuntimeError("walker pool failed to drain (scheduler bug?)")


def _adaptive_targets(acc, D, n_pairs, kappa):
    """Each point's optimal-allocation target in pairs (pool.py:429-450),
    in float32 numpy from the accumulator `acc` (N, 4 + 2D): for a total
    walk budget, sum_i sigma_i^2 / n_i is least with n_i ~ sigma_i, and
    the allocation that equals the fixed scheme's RMS standard error with
    the fewest walks is n_i* = n_pairs * sigma_i * mean(sigma) /
    mean(sigma^2); the target is kappa x the larger of the solution's and
    the gradient magnitude's n_i*, each sigma from the point's standard
    error of the mean times sqrt(n)."""
    nw = np.maximum(acc[:, 2], 2.0)
    mean_g = acc[:, 3:3 + D] / nw[:, None]
    var_g = np.maximum(acc[:, 3 + D:3 + 2 * D] / nw[:, None] - mean_g ** 2,
                       0.0)
    mean_s = acc[:, 0] / nw
    var_s = np.maximum(acc[:, 3 + 2 * D] / nw - mean_s ** 2, 0.0)
    sem_s, sem_g = np.sqrt(var_s / nw), np.sqrt(var_g.sum(1) / nw)

    def target(sigma):
        s2 = np.mean(sigma ** 2)
        if s2 <= 0.0:
            return np.full(len(sigma), n_pairs)
        return n_pairs * sigma * np.mean(sigma) / s2

    return kappa * np.maximum(target(sem_s * np.sqrt(nw)),
                              target(sem_g * np.sqrt(nw)))


def _adaptive_bounds(C, n_pairs, rounds):
    """The adaptive rounds' pair ends: geometric from the warmup C to
    n_pairs over max(2, rounds) rounds (pool.py:391-394)."""
    R = max(2, rounds)
    ratio = (n_pairs / C) ** (1.0 / (R - 1))
    return sorted({min(n_pairs, int(round(C * ratio ** k)))
                   for k in range(1, R)} | {n_pairs})


def obstacle_scene(device="cuda"):
    """A karman-like scene whose points differ in variance, where adaptive
    allocation pays (the JAX package's tests/test_pool.py:156-200): an
    open channel 2 high with a circle of radius 0.25 at (2, 1), sigma 350,
    the source sin(x) cos(2y); and 32 points from numpy's seed 0, 8 at
    0.30 from the circle's centre and 24 in the far field. Returns
    (WostScene, float32 points (32, 2)) on `device`."""
    from ..geometry.analytic2d import make_analytic2d
    from .solver import WostScene
    geom = make_analytic2d((-1e6, 0.0), (1e6, 2.0),
                           circles=[(2.0, 1.0, 0.25)],
                           sil_pts=[(0.0, 0.0), (8.0, 0.0), (0.0, 2.0),
                                    (8.0, 2.0)],
                           bbox=((0.0, 0.0), (8.0, 2.0)), device=device)
    scene = WostScene(dim=2, neumann=geom, absorption=350.0,
                      source_fn=lambda x: torch.sin(x[..., 0])
                      * torch.cos(2.0 * x[..., 1]))
    rng = np.random.default_rng(0)
    far = np.stack([rng.uniform(4.5, 7.5, 24), rng.uniform(0.3, 1.7, 24)], 1)
    ang = rng.uniform(0, 2 * np.pi, 8)
    near = np.stack([2.0 + 0.30 * np.cos(ang), 1.0 + 0.30 * np.sin(ang)], 1)
    return scene, torch.from_numpy(np.concatenate([near, far]).astype(
        np.float32)).to(device)


def estimate_solution_and_gradient_pool(scene: WostScene,
                                        settings: WalkSettings, pts, key,
                                        n_walks=None, mask_invalid=True,
                                        source_args=()):
    """Solution and gradient at interior points pts (N, D) on the walker
    pool (pool.py:596-748), with adaptive allocation when adaptive_walks >
    0 (see the module docstring). `key` is a key object (utils/keys.py).
    Returns (p (N,), grad (N, D), n_valid (N,) int32)."""
    if not settings.fast_rng:
        raise ValueError("pool mode needs the counter-based fast RNG")
    t0 = time.perf_counter()
    counts["drains"] += 1
    n_walks_total = n_walks or settings.n_walks
    n_anti = 2 if settings.use_gradient_antithetic_variates else 1
    n_pairs = (max(1, n_walks_total // 2) if n_anti == 2
               else n_walks_total)
    N, D = pts.shape
    dev = pts.device
    W = n_pairs * n_anti * N
    S = settings.pool_slots or min(8 * N, 1 << 20)
    S = max(n_anti, min(S, W))
    K = max(1, settings.pool_refill_every)
    kappa = settings.adaptive_walks

    pd = _precompute(scene, settings, pts, key)
    seeds = (key.fold_in(1).stream_seed(), key.fold_in(2).stream_seed())

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    carry = PoolCarry(
        next_lane=0,
        st=_fresh_state(zeros(S, D), thr=zeros(S),
                        status=torch.full((S,), EMPTY, dtype=torch.int64,
                                          device=dev)),
        g=torch.zeros(S, dtype=torch.int64, device=dev), ok=zeros(S),
        first_src=zeros(S), bgd_vec=zeros(S, D), sgd_vec=zeros(S, D),
        acc=zeros(N, 4 + 2 * D) if kappa > 0.0 else zeros(N, 3 + D))

    def run(lo_pair, hi_pair, cv, carry, active_idx=None):
        n_active = N if active_idx is None else active_idx.numel()
        carry = carry._replace(next_lane=lo_pair * n_anti * n_active)
        g_hi = hi_pair * n_anti * n_active
        # a generous guard: every queued walk at the step cap, plus slack
        w_round = (hi_pair - lo_pair) * n_anti * n_active
        max_trips = 8 + (-(-w_round // S) + 1) * (
            -(-settings.pool_step_cap // K) + 2)
        return _pool_launch(scene, settings, n_pairs, n_anti, N, pd, seeds,
                            g_hi, cv, carry, source_args, max_trips,
                            n_active, active_idx)

    zcv = zeros(N, 2)
    C = min(n_pairs, max(1, settings.cv_warmup_pairs))
    with torch.no_grad():
        if n_pairs > C and (settings.use_gradient_control_variates
                            or kappa > 0.0):
            # warm-up pairs run with zero CV; the frozen CV is independent
            # of the remaining pairs (unbiased, walk_on_stars.h:501-506)
            carry = run(0, C, zcv, carry)
            cv = zcv
            if settings.use_gradient_control_variates:
                nv = torch.clamp(carry.acc[:, 2], min=1.0)
                cv = carry.acc[:, 0:2] / nv[:, None]  # [cv_b | cv_s]
            if kappa > 0.0:
                lo = C
                for hi in _adaptive_bounds(C, n_pairs,
                                           settings.adaptive_rounds):
                    if hi <= lo:
                        continue
                    if lo == C:
                        # every point takes the first post-warmup round:
                        # the warmup's pairs carry no control variates
                        alive = np.arange(N)
                    else:
                        tgt = _adaptive_targets(carry.acc.cpu().numpy(), D,
                                                n_pairs, kappa)
                        alive = np.nonzero(lo < tgt)[0]
                    if len(alive) == 0:
                        break
                    counts["rounds"] += 1
                    counts["alive"] += len(alive)
                    carry = run(lo, hi, cv, carry,
                                torch.from_numpy(alive).to(dev))
                    lo = hi
            else:
                carry = run(C, n_pairs, cv, carry)
        else:
            carry = run(0, n_pairs, zcv, carry)

    n_valid = carry.acc[:, 2]
    denom = torch.clamp(n_valid, min=1.0)
    p = carry.acc[:, 0] / denom
    grad = carry.acc[:, 3:3 + D] / denom[:, None]
    if mask_invalid:
        p = torch.where(pd.degenerate, 0.0, p)
        grad = torch.where(pd.degenerate[..., None], 0.0, grad)
    counts["seconds"] += time.perf_counter() - t0
    return p, grad, n_valid.to(torch.int32)
