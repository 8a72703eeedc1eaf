"""Batched walk-on-stars estimator for screened Poisson problems (port of
nmcfluid/wost/solver.py).

`_advance` is one step of every active lane (walk_on_stars.h:135-329):
star radius (maximal spheres after `steps_before_maximal_spheres`),
uniform direction with a hemisphere flip on the Neumann boundary (and the
double-sided normal flip), ray clip or arc step, the single-sample
Neumann boundary term when the boundary data is nonzero, the in-ball
source sample along the walk direction, Russian roulette on the
direction-sampled Poisson kernel, harmonic Green's functions for the
first `steps_before_tikhonov` steps, and termination inside the epsilon
shell of a Dirichlet boundary. `_walk` advances lanes until they end,
keyed either by fastrand on (loop step, lane) or, with fast_rng=False, by
one key.fold_in(step).fold_in(salt + 16).uniform draw per salt, as the
JAX package keys them; `estimate_solution` is the solution-only walk.
`estimate_solution_and_gradient` routes the gradient estimator as the
JAX package does: to the generation executor (wost/gen.py) or the walker
pool (wost/pool.py, also every adaptive run) under the fast RNG, and
to the lockstep executor (`_lockstep_gradient`, the JAX package's
_grad_launch: antithetic pairs walked side by side, control variates
refreshed per pair batch) under algo="lockstep" or fast_rng=False. Every
branch runs in 2D (segment soups, geometry/queries2d.py) and in 3D
(triangle soups, geometry/queries3d.py; the shipped scenes' cube by its
closed forms).
"""
import dataclasses
import math
from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import torch

from ..geometry import queries2d, queries3d
from ..geometry.sdf import sqrt_rn
from ..ops import fastrand, greens2d, greens3d
from ..ops.sampling import pdf_unit_sphere, unit_sphere_from_u

RADIUS_SHRINK = 0.99  # walk_on_stars.h:9

# walk completion codes
ACTIVE, DONE_RR, DONE_DIRICHLET, DROP_ESCAPED, DROP_MAXLEN = 0, 1, 2, 3, 4

# lanes a lockstep pass holds at most (whole pairs; at least one): the
# walker pool's slots at a 65,536-point chunk, min(8 N, 2^20)
_LOCKSTEP_LANES = 1 << 19

# counts since the caller last zeroed them: the lockstep gradient's
# passes (a pass walks a block of pairs side by side) and the loop steps
# of _walk (the solution-only walk's and the lockstep gradient's)
counts = {"passes": 0, "steps": 0}


@dataclasses.dataclass(frozen=True)
class WalkSettings:
    """Mirror of zombie::WalkSettings (walk_on_stars.h:679-742) and of the
    JAX package's estimator settings, less its TPU launch guards
    (pool_trips_per_launch, gen_groups_per_launch, gen_tail_div).
    pairs_per_launch stays as what it also is in JAX: with pair_batch the
    partition of the lockstep gradient's pairs into batches that share a
    control-variate refresh."""
    epsilon_shell: float = 1e-3
    min_star_radius: float = 1e-3
    silhouette_precision: float = 1e-3
    russian_roulette_threshold: float = 0.99
    max_walk_length: int = 10_000
    steps_before_tikhonov: int = 0
    steps_before_maximal_spheres: int = 10_000
    n_walks: int = 500
    # the loop cap of the solution-only walk and of the lockstep gradient
    walk_step_cap: int = 64
    ignore_dirichlet: bool = True
    ignore_neumann: bool = False
    ignore_source: bool = False
    # double-sided boundaries (walk_on_stars.h:734, pde.h:20-24): a walker
    # that reaches the Neumann boundary through its front face has its
    # stored normal flipped; boundary values become side-dependent
    solve_double_sided: bool = False
    use_gradient_control_variates: bool = True
    use_gradient_antithetic_variates: bool = True
    fast_rng: bool = True
    # the lockstep gradient's pairs run in launches of pairs_per_launch,
    # each in batches of min(pair_batch, launch pairs) whose control
    # variates are refreshed once (solver.py:736-760)
    pair_batch: int = 1
    pairs_per_launch: int = 50
    # gradient executor: "gen" (wost/gen.py), "pool" (wost/pool.py) or
    # "lockstep" (_lockstep_gradient, which also takes fast_rng=False)
    algo: str = "gen"
    # walker pool: slots (0 -> min(8 N, 2^20)), walk steps between
    # scatter/refill trips, and the per-walk step cap
    pool_slots: int = 0
    pool_refill_every: int = 3
    pool_step_cap: int = 1024
    # pairs run with zero control variates before the CVs freeze
    # (walk_on_stars.h:501-506)
    cv_warmup_pairs: int = 16
    # adaptive walk allocation (the pool's optimal-allocation rounds,
    # wost/pool.py): kappa > 0 turns it on, over adaptive_rounds rounds.
    # Default off: the JAX package measured it as a negative on karman
    # (PARITY.md:652)
    adaptive_walks: float = 0.0
    adaptive_rounds: int = 4
    # generation executor: pairs per generation, and the per-walk step
    # cap beyond which a walk is dropped (reference maxWalkLength)
    gen_group_pairs: int = 4
    gen_step_cap: int = 1024


@dataclasses.dataclass(frozen=True, eq=False)
class WostScene:
    """Static PDE + geometry description (zombie::PDE, core/pde.h:14-27).
    `source_fn(x, *source_args)` is the volumetric source. `neumann_fn`
    and `dirichlet_fn` of None mean zero boundary data, and the walk
    skips those terms; the double-sided variants take (x, side) with a
    bool side: the sign of the signed distance to the Dirichlet boundary
    at termination (dirichlet_ds_fn), zombie's
    estimateBoundaryNormalAligned flag (neumann_ds_fn)."""
    dim: int
    neumann: object                 # Analytic2D or Seg2D, Box3D or Tri3D
    source_fn: Callable
    absorption: float = 0.0
    dirichlet: Optional[object] = None      # Seg2D or Tri3D
    neumann_fn: Optional[Callable] = None
    dirichlet_fn: Optional[Callable] = None
    dirichlet_ds_fn: Optional[Callable] = None
    neumann_ds_fn: Optional[Callable] = None

    def qmod(self):
        """The query module: queries2d in 2D (a segment soup, or an
        Analytic2D boundary it hands to analytic2d), queries3d in 3D (a
        triangle soup, or a Box3D it hands to analytic3d)."""
        return queries2d if self.dim == 2 else queries3d

    def greens(self):
        return _get_greens(self.dim, float(self.absorption))


@lru_cache(maxsize=None)
def _get_greens(dim: int, absorption: float):
    """One Green's-function object per (dim, sigma): its radius table is
    built once on the host. sigma = 0 is the harmonic class."""
    if absorption > 0.0:
        return (greens2d.Yukawa2D if dim == 2 else greens3d.Yukawa3D)(
            absorption)
    return greens2d.Harmonic2D if dim == 2 else greens3d.Harmonic3D


def _harmonic(dim):
    return greens2d.Harmonic2D if dim == 2 else greens3d.Harmonic3D


class WalkState(NamedTuple):
    x: torch.Tensor            # (..., D) current position
    n: torch.Tensor            # (..., D) current normal (stale unless on bdry)
    on_neumann: torch.Tensor   # (...,) bool
    thr: torch.Tensor          # (...,) throughput
    acc: torch.Tensor          # (...,) accumulated source + Neumann terms
    steps: torch.Tensor        # (...,) int64
    status: torch.Tensor       # (...,) int64 completion code
    first_radius: torch.Tensor  # (...,) >0 -> use as first star radius
    # double-sided only: this step hit the boundary through its front face
    # and the stored normal was flipped (walk_on_stars.h:152-159)
    flipped: torch.Tensor      # (...,) bool


def _fresh_state(x, **over):
    """WalkState at interior positions x with all-default per-lane fields."""
    lanes = x.shape[:-1]
    dev = x.device
    base = dict(
        x=x, n=torch.zeros_like(x),
        on_neumann=torch.zeros(lanes, dtype=torch.bool, device=dev),
        thr=torch.ones(lanes, dtype=torch.float32, device=dev),
        acc=torch.zeros(lanes, dtype=torch.float32, device=dev),
        steps=torch.zeros(lanes, dtype=torch.int64, device=dev),
        status=torch.full(lanes, ACTIVE, dtype=torch.int64, device=dev),
        first_radius=torch.zeros(lanes, dtype=torch.float32, device=dev),
        flipped=torch.zeros(lanes, dtype=torch.bool, device=dev))
    base.update(over)
    return WalkState(**base)


def _dirichlet_dist(scene, x):
    """Distance to the Dirichlet boundary; without one, zombie's fallback:
    the distance to the far bbox corner (fcpw_scene_loader.h:299-315)."""
    q = scene.qmod()
    if scene.dirichlet is None:
        return q.dist_to_far_bbox_corner(scene.neumann, x)
    return q.distance(scene.dirichlet, x)


def _categorical_u(w, u):
    """Inverse-CDF categorical pick over the last axis of nonnegative
    weights `w` from one uniform per lane."""
    cdf = torch.cumsum(w, dim=-1)
    tot = cdf[..., -1:]
    idx = torch.sum((cdf < u[..., None] * tot).to(torch.int64), dim=-1)
    return torch.clamp(idx, 0, w.shape[-1] - 1)


def _sample_neumann_boundary(scene, x, u_sel, u_pt):
    """Single-sample Neumann boundary pick, |G|-size-weighted
    (fcpw_scene_loader.h:599-620 with the traversal weight of
    demo/scene.h:157-160: per element |G3D(max(d, 1e-2))| * its length
    or area). `u_sel` (lanes,) picks the element, `u_pt` (lanes, 2) places
    the point on it (its first column only in 2D). Returns (point, normal,
    pdf w.r.t. boundary length in 2D, area in 3D)."""
    if scene.dim == 3:
        return _sample_neumann_triangles(scene.neumann, x, u_sel, u_pt)
    soup = scene.neumann
    a, b = soup.a, soup.b
    seg = b - a
    ln = torch.linalg.vector_norm(seg, dim=-1)
    ab = seg / torch.clamp(ln, min=1e-20)[..., None]
    xa = x[..., None, :] - a
    t = torch.minimum(torch.clamp(torch.sum(xa * ab, -1), min=0.0), ln)
    p = a + t[..., None] * ab
    d = torch.linalg.vector_norm(x[..., None, :] - p, dim=-1)
    w = ln / (4.0 * math.pi * torch.clamp(d, min=1e-2))
    w = torch.where(ln > 1e-12, w, 0.0)
    tot = torch.sum(w, -1)
    idx = _categorical_u(w, u_sel)
    u = u_pt[..., 0]
    pa, pb = a[idx], b[idx]
    pt = pa + u[..., None] * (pb - pa)
    li = ln[idx]
    pdf = torch.gather(w, -1, idx[..., None])[..., 0]
    pdf = pdf / torch.clamp(tot, min=1e-30) / torch.clamp(li, min=1e-20)
    return pt, soup.n[idx], pdf


def _sample_neumann_triangles(tri, x, u_sel, u_pt):
    """The 3D branch of _sample_neumann_boundary on a Tri3D: one
    categorical pick over area * G3D(max(d, 1e-2)) with d the distance to
    the triangle (the padded zero-area slots weigh 0), a uniform point on
    it by sqrt-mapped barycentrics, the pdf over the area measure."""
    area = 0.5 * sqrt_rn(torch.sum(
        queries3d._cross(tri.vb - tri.va, tri.vc - tri.va) ** 2, -1))
    cp = queries3d._closest_on_tri(x[..., None, :], tri.va, tri.vb, tri.vc)
    d = sqrt_rn(torch.sum((x[..., None, :] - cp) ** 2, -1))   # (..., P)
    w = area / (4.0 * math.pi * torch.clamp(d, min=1e-2))
    tot = torch.sum(w, -1)
    idx = _categorical_u(w, u_sel)
    su = sqrt_rn(u_pt[..., 0:1])
    b1 = su * (1.0 - u_pt[..., 1:2])
    b2 = su * u_pt[..., 1:2]
    pt = (1.0 - su) * tri.va[idx] + b1 * tri.vb[idx] + b2 * tri.vc[idx]
    pdf = torch.gather(w, -1, idx[..., None])[..., 0]
    pdf = pdf / torch.clamp(tot, min=1e-30) / torch.clamp(area[idx],
                                                          min=1e-20)
    return pt, tri.n[idx], pdf


def _advance(scene, greens, settings: WalkSettings, st: WalkState, draw,
             source_args=(), step_cap=None):
    """One walk step for every ACTIVE lane (walk_on_stars.h:135-329).

    `draw(salt, shape)` supplies the step's uniforms (the caller keys the
    streams). `step_cap` overrides max_walk_length as the DROP_MAXLEN
    threshold."""
    q = scene.qmod()
    D = scene.dim
    rr = settings.russian_roulette_threshold
    soup = scene.neumann
    # mid-walk Tikhonov (walk_on_stars.h:319-321): the harmonic Green's
    # function for the first K steps, the screened one after, per lane
    K_tik = settings.steps_before_tikhonov
    mixed = scene.absorption > 0.0 and K_tik > 0
    g_harm = _harmonic(D)
    M_max = settings.steps_before_maximal_spheres
    cap = settings.max_walk_length if step_cap is None else step_cap

    active = st.status == ACTIVE

    dd = _dirichlet_dist(scene, st.x)
    star = q.star_radius(soup, st.x, settings.min_star_radius, dd)
    star = torch.where(settings.min_star_radius <= dd,
                       torch.clamp(RADIUS_SHRINK * star,
                                   min=settings.min_star_radius), star)
    if M_max < settings.max_walk_length:
        # maximal spheres after M steps (walk_on_stars.h:162-164): the
        # distance to the Dirichlet boundary, no silhouette, no shrink
        star = torch.where(st.steps >= M_max, dd, star)
    R = torch.where(st.first_radius > 0.0, st.first_radius, star)
    ball = greens.make_ball(R)
    if mixed:
        ball_h = g_harm.make_ball(R)
        on_yukawa = st.steps >= K_tik

    u_dir = torch.stack([draw(s_, R.shape) for s_ in range(D - 1)], dim=-1)
    d = unit_sphere_from_u(u_dir, D).expand(st.x.shape)
    flip = st.on_neumann & (torch.sum(st.n * d, -1) > 0.0)
    d = torch.where(flip[..., None], -d, d)

    off = q.OFFSET_EPS * torch.clamp(
        torch.linalg.vector_norm(st.x, dim=-1), min=1.0)[..., None]
    o_eff = torch.where(st.on_neumann[..., None], st.x - st.n * off, st.x)
    hit, t_hit, hit_pt, hit_n = q.ray_intersect(soup, o_eff, d, R)
    arc_pt = o_eff + R[..., None] * d
    new_pt = torch.where(hit[..., None], hit_pt, arc_pt)
    new_flipped = st.flipped
    if settings.solve_double_sided:
        # a walker hitting the FRONT face keeps to the side it came from
        # by flipping the stored normal (walk_on_stars.h:152-159); the
        # flag holds for this step's hit only
        front = torch.sum(d * hit_n, -1) < 0.0
        hit_n = torch.where((hit & front)[..., None], -hit_n, hit_n)
        new_flipped = hit & front
    new_n = torch.where(hit[..., None], hit_n, st.n)

    acc = st.acc
    # ---- Neumann boundary term (zero boundary data skips it)
    use_ds_neumann = (settings.solve_double_sided
                      and scene.neumann_ds_fn is not None)
    if (scene.neumann_fn is not None or use_ds_neumann) \
            and not settings.ignore_neumann:
        u_sel = draw(6, R.shape)
        u_pt = torch.stack([draw(7, R.shape), draw(8, R.shape)], dim=-1)
        bpt, bn, bpdf = _sample_neumann_boundary(scene, st.x, u_sel, u_pt)
        bdist = torch.linalg.vector_norm(bpt - st.x, dim=-1)
        alpha = torch.where(st.on_neumann, 2.0, 1.0)
        vis = q.has_line_of_sight(soup, o_eff, bpt)
        ok = (bpdf > 0.0) & (bdist < R) & vis
        rb = torch.clamp(bdist, min=greens2d.R_CLAMP)
        G = greens.eval(ball, rb)
        if mixed:
            G = torch.where(on_yukawa, G, g_harm.eval(ball_h, rb))
        if use_ds_neumann:
            # estimateBoundaryNormalAligned (walk_on_stars.h:221-253)
            prec = settings.silhouette_precision
            dirn = (bpt - st.x) / torch.clamp(bdist, min=1e-20)[..., None]
            faces_away = torch.sum(dirn * bn, -1) < -prec
            concave_ok = torch.where(st.on_neumann,
                                     torch.sum(dirn * st.n, -1) < -prec,
                                     True)
            aligned = st.flipped | (faces_away & concave_ok)
            h = scene.neumann_ds_fn(bpt, aligned)
        else:
            h = scene.neumann_fn(bpt)
        acc = acc + torch.where(active & ok,
                                st.thr * alpha * G * h / bpdf, 0.0)

    # ---- source term: radius along the walk direction, star-clipped
    if not settings.ignore_source:
        u2 = torch.stack([draw(4, R.shape), draw(5, R.shape)], dim=-1)
        r_src, _ = greens.sample_radius_u(ball, u2)
        g_norm = greens.norm(ball)
        if mixed:
            r_h, _ = g_harm.sample_radius_u(ball_h, u2)
            r_src = torch.where(on_yukawa, r_src, r_h)
            g_norm = torch.where(on_yukawa, g_norm, g_harm.norm(ball_h))
        y = st.x + r_src[..., None] * d
        take = r_src <= t_hit
        contrib = g_norm * scene.source_fn(y, *source_args)
        acc = acc + torch.where(active & take, st.thr * contrib, 0.0)

    escaped = (~hit) & q.outside_bbox(soup, new_pt)

    r_new = torch.linalg.vector_norm(new_pt - st.x, dim=-1)
    dspk = greens.dspk(ball, r_new)
    if mixed:
        dspk = torch.where(on_yukawa, dspk, g_harm.dspk(ball_h, r_new))
    thr = st.thr * dspk
    u_rr = draw(3, thr.shape)
    below = thr < rr
    die = below & (thr / rr < u_rr)
    thr = torch.where(below & ~die, rr, thr)
    steps = st.steps + 1

    status = st.status
    status = torch.where(active & escaped, DROP_ESCAPED, status)
    status = torch.where(active & ~escaped & die, DONE_RR, status)
    status = torch.where(active & ~escaped & ~die & (steps > cap),
                         DROP_MAXLEN, status)
    if scene.dirichlet is not None:
        dd_new = _dirichlet_dist(scene, new_pt)
        status = torch.where((status == ACTIVE)
                             & (dd_new <= settings.epsilon_shell),
                             DONE_DIRICHLET, status)

    a1 = active[..., None]
    return WalkState(
        x=torch.where(a1, new_pt, st.x),
        n=torch.where(a1, new_n, st.n),
        on_neumann=torch.where(active, hit, st.on_neumann),
        thr=torch.where(active, torch.where(die, 0.0, thr), st.thr),
        acc=acc,
        steps=torch.where(active, steps, st.steps),
        status=status,
        first_radius=torch.zeros_like(st.first_radius),
        flipped=torch.where(active, new_flipped, st.flipped),
    )


def _double_sided_dirichlet(scene, settings):
    return settings.solve_double_sided and scene.dirichlet_ds_fn is not None


def has_terminal(scene, settings):
    """True when walks ending in the epsilon shell collect Dirichlet
    data."""
    return not settings.ignore_dirichlet and (
        _double_sided_dirichlet(scene, settings)
        or scene.dirichlet_fn is not None)


def terminal_values(scene, settings, x, status):
    """The Dirichlet value each lane collects at termination, 0 where it
    did not end in the epsilon shell (needs has_terminal):
    dirichletDoubleSided(x, side) with side the sign of the signed
    distance (walk_on_stars.h:332-341) when solving double-sided, else
    dirichlet_fn(x)."""
    if _double_sided_dirichlet(scene, settings):
        sd = scene.qmod().signed_distance(scene.dirichlet, x)
        g = scene.dirichlet_ds_fn(x, sd > 0.0)
    else:
        g = scene.dirichlet_fn(x)
    return torch.where(status == DONE_DIRICHLET, g, 0.0)


def _walk(scene, greens, settings: WalkSettings, state: WalkState, key,
          source_args=(), rand_shape=None):
    """Advance the lanes of `state` until every walk has terminated or
    walk_step_cap steps have run; lanes still active then are dropped
    (DROP_MAXLEN). `key` is one key, or a list of P keys for P equal
    leading blocks of the lanes (a lockstep pass of P pairs, each pair on
    its own key, as the JAX package's vmap over pairs). Within a block the
    draws are made over `rand_shape`, a trailing part of the block's shape
    (None: the whole block), and broadcast over the rest: the two halves
    of an antithetic pair share their uniforms (solver.py:480-531,
    walk_on_stars.h:579). They are keyed on (loop step, lane of
    rand_shape): by fastrand with fast_rng, else one
    key.fold_in(step).fold_in(salt + 16).uniform(rand_shape) draw per salt.
    Only the active lanes are advanced, and the streams are per lane, so
    this gives the same walks as advancing every lane. Returns (total,
    valid, steps) in the lanes' shape."""
    shape = state.status.shape
    dev = state.x.device
    keys = key if isinstance(key, list) else [key]
    P = len(keys)
    flat = WalkState(*(f.reshape((-1,) + f.shape[len(shape):])
                       for f in state))
    n = flat.status.shape[0]
    block = n // P
    rshape = tuple(shape[1:] if P > 1 else shape) if rand_shape is None \
        else tuple(rand_shape)
    n_rand = math.prod(rshape)
    lanes = torch.arange(n, device=dev)
    if settings.fast_rng:
        seeds = [k.stream_seed() for k in keys]
        seed_of = torch.tensor(seeds, dtype=torch.int64, device=dev)
    out = [f.clone() for f in flat]
    idx, sub = lanes, flat
    for it in range(settings.walk_step_cap):
        counts["steps"] += 1
        blk = torch.div(idx, block, rounding_mode="floor")
        r = torch.remainder(idx - blk * block, n_rand)
        if settings.fast_rng:
            seed = seeds[0] if P == 1 else seed_of[blk]

            def draw(salt, shp, it=it, seed=seed, r=r):
                return fastrand.uniform(seed, it, salt, r).expand(shp)
        else:
            # one draw a salt for each block with active lanes
            live = torch.unique(blk).tolist()
            row = torch.zeros(P, dtype=torch.int64, device=dev)
            row[live] = torch.arange(len(live), device=dev)
            ksteps = [keys[b].fold_in(it) for b in live]
            pick = row[blk] * n_rand + r

            def draw(salt, shp, ksteps=ksteps, pick=pick):
                u = _uniform_rows(ksteps, salt + 16, rshape, dev)
                return u.reshape(-1)[pick].expand(shp)
        sub = _advance(scene, greens, settings, sub, draw, source_args)
        for o, f in zip(out, sub):
            o[idx] = f
        keep = (sub.status == ACTIVE).nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        if keep.numel() < idx.numel():
            idx = idx[keep]
            sub = WalkState(*(f[keep] for f in sub))
    final = WalkState(*out)
    status = torch.where(final.status == ACTIVE, DROP_MAXLEN, final.status)
    total = final.acc
    if has_terminal(scene, settings):
        total = total + final.thr * terminal_values(scene, settings,
                                                    final.x, status)
    valid = (status == DONE_RR) | (status == DONE_DIRICHLET)
    return (total.reshape(shape), valid.reshape(shape),
            final.steps.reshape(shape))


def _first_sphere_radius_solution(scene, settings, pts):
    """First star radius for solution-only estimation
    (walk_on_stars.h:403-424)."""
    q = scene.qmod()
    dd = _dirichlet_dist(scene, pts)
    star = q.star_radius(scene.neumann, pts, settings.min_star_radius, dd)
    return torch.where(settings.min_star_radius <= dd,
                       torch.clamp(RADIUS_SHRINK * star,
                                   min=settings.min_star_radius), star)


def estimate_solution(scene: WostScene, settings: WalkSettings, pts, key,
                      n_walks: Optional[int] = None, source_args=()):
    """The PDE solution at pts (N, D) from n_walks walks each
    (solver.py:546-567). `key` is a key object (utils/keys.py). Returns
    (p (N,), n_valid (N,) int64, mean_steps (N,))."""
    greens = scene.greens()
    n_walks = n_walks or settings.n_walks
    N = pts.shape[0]
    first_r = _first_sphere_radius_solution(scene, settings, pts)
    lanes = (n_walks, N)
    st = _fresh_state(pts.expand(lanes + (scene.dim,)).contiguous(),
                      first_radius=first_r.expand(lanes).contiguous())
    with torch.no_grad():
        total, valid, steps = _walk(scene, greens, settings, st, key,
                                    source_args)
    n_valid = torch.sum(valid, dim=0)
    denom = torch.clamp(n_valid, min=1)
    p = torch.sum(torch.where(valid, total, 0.0), dim=0) / denom
    mean_steps = torch.sum(torch.where(valid, steps, 0), dim=0) / denom
    return p, n_valid, mean_steps


def _uniform_rows(keys, data, shape, device):
    """Each key's key.fold_in(data).uniform(shape) draw, stacked."""
    return torch.stack([k.fold_in(data).uniform(shape, device)
                        for k in keys])


def _stratified_pair_u(jit, w, n_pairs, rot, dim):
    """Per-pair stratified uniforms in [0,1)^{dim-1} with the per-point
    Cranley-Patterson rotation `rot` (N, dim-1), standing in for the
    per-point stratified sequences of walk_on_stars.h:489-491
    (solver.py:570-586), for the pairs w (P, 1) int64 at once: `jit` is
    each pair's key.uniform over the points, (P, N), and (P, N, 2) in 3D,
    where the pair index is laid on a near-square grid for 2D strata.
    Returns (P, N, dim-1)."""
    if dim == 2:
        u = torch.remainder((w.to(torch.float32) + jit) / n_pairs
                            + rot[..., 0], 1.0)
        return u[..., None]
    a = int(math.ceil(math.sqrt(n_pairs)))
    wi = torch.remainder(w, a).to(torch.float32)
    wj = torch.div(w, a, rounding_mode="floor").to(torch.float32)
    u0 = torch.remainder((wi + jit[..., 0]) / a + rot[..., 0], 1.0)
    u1 = torch.remainder((wj + jit[..., 1]) / ((n_pairs + a - 1) // a)
                         + rot[..., 1], 1.0)
    return torch.stack([u0, u1], dim=-1)


def _pair_batches(settings, n_pairs):
    """The lockstep gradient's partition of the pair indices
    (solver.py:617-629, 736-760): launches of pairs_per_launch pairs, each
    in batches of G = min(pair_batch, the launch's pairs); the control
    variates are refreshed at the start of each batch. Returns the
    batches as (first pair, end) ranges, in order; a launch's last batch
    is cut at the launch's end (JAX pads it and drops the padding)."""
    L = max(1, settings.pairs_per_launch)
    out = []
    for lo in range(0, n_pairs, L):
        hi = min(lo + L, n_pairs)
        G = max(1, min(settings.pair_batch, hi - lo))
        out += [(b, min(b + G, hi)) for b in range(lo, hi, G)]
    return out


def _lockstep_gradient(scene: WostScene, settings: WalkSettings, pts, key,
                       n_walks=None, mask_invalid=True, source_args=()):
    """The lockstep gradient estimator (solver.py:612-763, _grad_launch):
    antithetic pairs with the first ball at 0.99 x the distance to the
    boundary (harmonic while Tikhonov is delayed), per pair w the key
    kw = key.fold_in(w): stratified first directions from kw.fold_in(0)
    and kw.fold_in(2) with the per-point rotation from
    key.fold_in(0xC0FFEE), the first radius from kw.fold_in(1), the walk
    on kw.fold_in(3) with the halves' draws shared over the points (N,);
    the e^{-Z}-free ratios pk_grad_over_thr and grad_norm_over_eval; the
    control variates from the running sums, refreshed at each batch of
    _pair_batches.

    The walks of a pair do not depend on the control variates, only the
    gradient's combination does. So the pairs are walked side by side in
    passes of as many pairs as fit in _LOCKSTEP_LANES lanes, their sums
    kept per pair, and folded in pair order, batch by batch: the
    sequential loop's numbers. Returns (p, grad (N, D), n_valid (N,)
    int32)."""
    greens = scene.greens()
    q = scene.qmod()
    D = scene.dim
    g1 = greens
    if scene.absorption > 0.0 and settings.steps_before_tikhonov > 0:
        g1 = _harmonic(D)
    n_walks = n_walks or settings.n_walks
    anti = settings.use_gradient_antithetic_variates
    n_pairs = max(1, n_walks // 2) if anti else n_walks
    n_anti = 2 if anti else 1
    N = pts.shape[0]
    dev = pts.device

    nd = q.distance(scene.neumann, pts)
    dd = _dirichlet_dist(scene, pts)
    R1 = RADIUS_SHRINK * torch.minimum(nd, dd)          # walk_on_stars.h:486
    degenerate = R1 <= 1e-6
    R1 = torch.clamp(R1, min=1e-6)
    ball1 = g1.make_ball(R1)
    norm1 = g1.norm(ball1)
    thr1 = g1.pk_over_uniform(ball1)
    pk_ratio = g1.pk_grad_over_thr(ball1)
    b_pdf = pdf_unit_sphere(D)
    rot = key.fold_in(0xC0FFEE).uniform((N, D - 1), dev)
    rot_b = torch.remainder(rot + 0.5, 1.0)
    signs = torch.tensor([1.0, -1.0], device=dev)[:n_anti, None, None]

    ball_b = type(ball1)(*(leaf[None] for leaf in ball1))
    jshape = (N,) if D == 2 else (N, 2)

    def first_samples(lo, hi):
        """The walk keys of pairs [lo, hi), their start points (P, A, N,
        D), first source samples (P, A, N) and signed gradient directions
        (P, A, N, D): pair w's draws from kw = key.fold_in(w), each pair's
        numbers those of its own loop in JAX."""
        kws = [key.fold_in(w) for w in range(lo, hi)]
        w = torch.arange(lo, hi, device=dev)[:, None]
        sg = signs[None]
        dir_s = unit_sphere_from_u(_stratified_pair_u(
            _uniform_rows(kws, 0, jshape, dev), w, n_pairs, rot, D), D)
        r_s, _ = g1.sample_radius_u(ball_b,
                                    _uniform_rows(kws, 1, (N, 2), dev))
        if settings.ignore_source:
            first_src = torch.zeros((len(kws), n_anti, N), device=dev)
            sgd = torch.zeros((len(kws), n_anti, N, D), device=dev)
        else:
            y_vol = pts + sg * (r_s[..., None] * dir_s)[:, None]
            first_src = norm1 * scene.source_fn(y_vol, *source_args)
            sgd = (sg * dir_s[:, None]) * (
                r_s * g1.grad_norm_over_eval(ball_b, r_s))[:, None, :, None]
        dir_b = unit_sphere_from_u(_stratified_pair_u(
            _uniform_rows(kws, 2, jshape, dev), w, n_pairs, rot_b, D), D)
        y_surf = pts + sg * (R1[:, None] * dir_b)[:, None]
        bgd = (sg * dir_b[:, None]) * (pk_ratio * R1 / b_pdf)[:, None]
        return [kw.fold_in(3) for kw in kws], y_surf, first_src, bgd, sgd

    per_pass = max(1, _LOCKSTEP_LANES // (n_anti * N))
    walked = {}          # pair -> (total, first_src, valid, bgd, sgd)

    def walk_pass(lo):
        """Walk pairs [lo, lo + per_pass) side by side; returns the end."""
        hi = min(lo + per_pass, n_pairs)
        counts["passes"] += 1
        kws, y_surf, first_src, bgd, sgd = first_samples(lo, hi)
        st = _fresh_state(y_surf,
                          thr=thr1.expand(first_src.shape).contiguous(),
                          acc=first_src)
        total, valid, _ = _walk(scene, greens, settings, st, kws,
                                source_args, rand_shape=(N,))
        valid = valid & ~degenerate
        for j, w in enumerate(range(lo, hi)):
            walked[w] = (total[j], first_src[j], valid[j], bgd[j], sgd[j])
        return hi

    sum_sol = torch.zeros(N, device=dev)
    sum_first = torch.zeros(N, device=dev)
    sum_grad = torch.zeros((N, D), device=dev)
    n_sol = torch.zeros(N, dtype=torch.int64, device=dev)
    next_pair = 0
    for b0, b1 in _pair_batches(settings, n_pairs):
        while next_pair < b1:
            next_pair = walk_pass(next_pair)
        if settings.use_gradient_control_variates:
            den = torch.clamp(n_sol, min=1)
            cv_b, cv_s = sum_sol / den, sum_first / den
        else:
            cv_b = cv_s = torch.zeros(N, device=dev)
        total, first_src, valid, bgd, sgd = (
            torch.stack(fs) for fs in zip(*(walked.pop(w)
                                            for w in range(b0, b1))))
        grad = ((total - first_src - cv_b)[..., None] * bgd
                + (first_src - cv_s)[..., None] * sgd)   # (G, A, N, D)
        vf = valid.to(torch.float32)
        sum_sol = sum_sol + torch.sum(vf * total, dim=(0, 1))
        sum_first = sum_first + torch.sum(vf * first_src, dim=(0, 1))
        n_sol = n_sol + torch.sum(valid, dim=(0, 1))
        sum_grad = sum_grad + torch.sum(vf[..., None] * grad, dim=(0, 1))
    den = torch.clamp(n_sol, min=1)
    p = sum_sol / den
    grad = sum_grad / den[..., None]
    if mask_invalid:
        p = torch.where(degenerate, 0.0, p)
        grad = torch.where(degenerate[..., None], 0.0, grad)
    return p, grad, n_sol.to(torch.int32)


def estimate_solution_and_gradient(scene: WostScene, settings: WalkSettings,
                                   pts, key, n_walks: Optional[int] = None,
                                   mask_invalid: bool = True,
                                   source_args=()):
    """Solution and gradient at interior pts (N, D), routed as
    solver.py:612-629 routes them: under the fast RNG, an adaptive run
    (adaptive_walks > 0 under "pool" or "gen") and algo "pool" go to the
    walker pool (wost/pool.py), algo "gen" to the generation executor
    (wost/gen.py); everything else, algo "lockstep" or any algo with
    fast_rng=False, to the lockstep executor (_lockstep_gradient).
    Returns (p, grad (N, D), n_valid (N,) int32)."""
    kw = dict(n_walks=n_walks, mask_invalid=mask_invalid,
              source_args=source_args)
    if settings.fast_rng and (settings.algo == "pool" or (
            settings.algo == "gen" and settings.adaptive_walks > 0.0)):
        from .pool import estimate_solution_and_gradient_pool as est
    elif settings.fast_rng and settings.algo == "gen":
        from .gen import estimate_solution_and_gradient_gen as est
    else:
        est = _lockstep_gradient
    return est(scene, settings, pts, key, **kw)
