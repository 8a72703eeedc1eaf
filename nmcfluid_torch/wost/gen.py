"""Generation executor of the WoSt gradient estimator (port of
nmcfluid/wost/gen.py).

Walks are issued in point-aligned generations of shape (G pairs,
2 antithetic halves, N points): per-point data broadcasts in and the
contributions reduce out with a plain sum over the (G, 2) axes. Each
generation advances until every lane has terminated or `gen_step_cap`
steps have run; lanes still active then are dropped from the statistics,
like the reference's maxWalkLength overruns (walk_on_stars.h:447-459).

Random streams are keyed per lane exactly as in the JAX package: start
draws on (pair, point) through pool._strat_dir and the fastrand salts,
continuation draws on (the lane's own step count, pair * N + point). So
the order in which lanes are advanced does not change any walk. This port
compacts the survivors after every step and advances only the active
lanes, which gives the same sums as the JAX package's one-shot compaction
(phase A/B, gen.py:144-192).

Estimator math (antithetic first samples, two-stage frozen control
variates with a group-aligned warmup, e^{-Z}-cancelled gradient ratios,
the Dirichlet terminal fold, single- and double-sided) is the JAX
package's, line for line.
"""
import torch

from ..ops import fastrand
from .pool import (_SALT_JIT_B, _SALT_JIT_S, _SALT_U2A, _SALT_U2B,
                   PointData, _first_greens, _precompute, _strat_dir)
from .solver import (ACTIVE, DONE_DIRICHLET, DONE_RR, DROP_MAXLEN,
                     WalkSettings, WalkState, WostScene, _advance,
                     _fresh_state, has_terminal, terminal_values)

# walk counts since the caller last zeroed them: generations run, steps
# advanced (one `_advance` each) and the lanes those steps advanced; read
# by chip_smoke.py to split the solve's time by step
counts = {"generations": 0, "steps": 0, "lane_steps": 0}


def _start_aligned(scene, settings, pd: PointData, seed2, w, live,
                   source_args, n_pairs, n_anti, N):
    """Start states for a (G, A, N) generation (gen.py:60-103). `w` is
    (G, 1, 1) pair indices; `live` masks padded pairs."""
    D = scene.dim
    g1 = _first_greens(scene, settings)
    G = w.shape[0]
    lanes = (G, n_anti, N)
    dev = pd.pts.device
    i = torch.arange(N, device=dev).reshape(1, 1, N)
    a = torch.arange(n_anti, device=dev).reshape(1, n_anti, 1)
    sign = 1.0 - 2.0 * a.to(torch.float32)
    rot = pd.rot                                             # (N, D-1)

    if settings.ignore_source:
        first_src = torch.zeros(lanes, dtype=torch.float32, device=dev)
        sgd_vec = torch.zeros(lanes + (D,), dtype=torch.float32, device=dev)
    else:
        dir_s = _strat_dir(seed2, w, i, _SALT_JIT_S, rot, 0.0, n_pairs, D)
        u2 = torch.stack([fastrand.uniform(seed2, w, _SALT_U2A, i),
                          fastrand.uniform(seed2, w, _SALT_U2B, i)], dim=-1)
        ball_b = type(pd.ball1)(*(leaf[None, None, :] for leaf in pd.ball1))
        r_s, _ = g1.sample_radius_u(ball_b, u2)              # (G, 1, N)
        y_vol = pd.pts + (sign[..., None] * (r_s * 1.0)[..., None]
                          * dir_s)
        first_src = pd.norm1 * scene.source_fn(y_vol, *source_args)
        sgd_vec = (sign * r_s
                   * g1.grad_norm_over_eval(ball_b, r_s))[..., None] * dir_s
        first_src = first_src.expand(lanes)
        sgd_vec = sgd_vec.expand(lanes + (D,))

    dir_b = _strat_dir(seed2, w, i, _SALT_JIT_B, rot, 0.5, n_pairs, D)
    bgd_vec = ((sign * pd.bgd)[..., None] * dir_b).expand(lanes + (D,))
    x0 = (pd.pts + (sign * pd.R1)[..., None] * dir_b).expand(lanes + (D,))
    st = _fresh_state(x0.contiguous(),
                      thr=pd.thr1.expand(lanes).contiguous(),
                      acc=first_src.contiguous())
    ok = (live & ~pd.degenerate).expand(lanes)
    return st, ok, first_src, bgd_vec, sgd_vec


def _run_generation(scene, greens, settings, st: WalkState, pl, seed_w,
                    source_args, keep_x=False):
    """Advance the flat lanes of `st` (S,) until none is active or
    `gen_step_cap` steps have run, advancing only the active lanes.
    Returns the final (acc, status) of every lane, and with keep_x its
    final (x, thr) too (the Dirichlet terminal fold reads them)."""
    cap = settings.gen_step_cap
    acc = st.acc.clone()
    status = st.status.clone()
    x, thr = (st.x.clone(), st.thr.clone()) if keep_x else (None, None)
    idx = torch.arange(status.shape[0], device=status.device)
    sub, pl_sub = st, pl
    counts["generations"] += 1
    for _ in range(cap):
        counts["steps"] += 1
        counts["lane_steps"] += idx.numel()
        steps = sub.steps

        def draw(salt, shape, steps=steps, pl_sub=pl_sub):
            return fastrand.uniform(seed_w, steps, salt, pl_sub).expand(shape)

        sub = _advance(scene, greens, settings, sub, draw, source_args,
                       step_cap=cap)
        acc[idx] = sub.acc
        status[idx] = sub.status
        if keep_x:
            x[idx] = sub.x
            thr[idx] = sub.thr
        keep = (sub.status == ACTIVE).nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        if keep.numel() < idx.numel():
            idx, pl_sub = idx[keep], pl_sub[keep]
            sub = WalkState(*(f[keep] for f in sub))
    status = torch.where(status == ACTIVE, DROP_MAXLEN, status)
    if keep_x:
        return acc, status, x, thr
    return acc, status


def _gen_group(scene: WostScene, settings: WalkSettings, n_pairs, n_anti,
               N, G, pd, seeds, lo, cv, source_args):
    """One generation of G pairs starting at pair `lo` (gen.py:120-218):
    returns its (N, 3 + D) contribution [sum_sol | sum_first | n_valid |
    sum_grad]."""
    seed_w, seed2 = seeds
    dev = pd.pts.device
    w = lo + torch.arange(G, device=dev).reshape(G, 1, 1)
    live = w < n_pairs
    st, ok, first_src, bgd_vec, sgd_vec = _start_aligned(
        scene, settings, pd, seed2, w, live, source_args, n_pairs, n_anti,
        N)
    # continuation streams: pair * N + point, shared by both halves
    i = torch.arange(N, device=dev).reshape(1, 1, N)
    pl = (w * N + i).expand(G, n_anti, N).reshape(-1)
    flat = WalkState(*(f.reshape((-1,) + f.shape[3:]) for f in st))
    fold = has_terminal(scene, settings)
    out = _run_generation(scene, scene.greens(), settings, flat, pl, seed_w,
                          source_args, keep_x=fold)
    total, status = out[0], out[1]
    if fold:
        # the Dirichlet terminal fold (gen.py:196-208)
        x, thr = out[2], out[3]
        total = total + thr * terminal_values(scene, settings, x, status)
    total = total.reshape(G, n_anti, N)
    status = status.reshape(G, n_anti, N)
    valid = ((status == DONE_RR) | (status == DONE_DIRICHLET)) & ok
    vf = valid.to(torch.float32)
    bc = total - first_src
    gvec = ((bc - cv[:, 0])[..., None] * bgd_vec
            + (first_src - cv[:, 1])[..., None] * sgd_vec)
    contrib = torch.cat(
        [(vf * total)[..., None], (vf * first_src)[..., None],
         vf[..., None], vf[..., None] * gvec], dim=-1)
    return contrib.sum(dim=(0, 1))


def estimate_solution_and_gradient_gen(scene: WostScene,
                                       settings: WalkSettings, pts, key,
                                       n_walks=None, mask_invalid=True,
                                       source_args=()):
    """Solution and gradient of the screened Poisson problem at interior
    points pts (N, D) (gen.py:223-271). `key` is a key object
    (utils/keys.py). Returns (p (N,), grad (N, D), n_valid (N,) int32)."""
    if not settings.fast_rng:
        raise ValueError("gen mode needs the counter-based fast RNG")
    n_walks_total = n_walks or settings.n_walks
    n_anti = 2 if settings.use_gradient_antithetic_variates else 1
    n_pairs = (max(1, n_walks_total // 2) if n_anti == 2
               else n_walks_total)
    N, D = pts.shape
    G = max(1, settings.gen_group_pairs)
    pd = _precompute(scene, settings, pts, key)
    seeds = (key.fold_in(1).stream_seed(), key.fold_in(2).stream_seed())
    acc = torch.zeros((N, 3 + D), dtype=torch.float32, device=pts.device)
    zcv = torch.zeros((N, 2), dtype=torch.float32, device=pts.device)

    def run(lo_pair, hi_pair, cv, acc):
        for lo in range(lo_pair, hi_pair, G):
            acc = acc + _gen_group(scene, settings, n_pairs, n_anti, N, G,
                                   pd, seeds, lo, cv, source_args)
        return acc

    C = min(n_pairs, max(1, settings.cv_warmup_pairs))
    if n_pairs > C and settings.use_gradient_control_variates:
        # warm-up pairs run with zero CV; the frozen CV is independent of
        # the remaining pairs (unbiased, walk_on_stars.h:501-506)
        C = -(-C // G) * G          # group-aligned warmup boundary
        C = min(C, n_pairs)
        acc = run(0, C, zcv, acc)
        nv = torch.clamp(acc[:, 2], min=1.0)
        cv = acc[:, 0:2] / nv[:, None]
        acc = run(C, n_pairs, cv, acc)
    else:
        acc = run(0, n_pairs, zcv, acc)

    n_valid = acc[:, 2]
    denom = torch.clamp(n_valid, min=1.0)
    p = acc[:, 0] / denom
    grad = acc[:, 3:3 + D] / denom[:, None]
    if mask_invalid:
        p = torch.where(pd.degenerate, 0.0, p)
        grad = torch.where(pd.degenerate[..., None], 0.0, grad)
    return p, grad, n_valid.to(torch.int32)
