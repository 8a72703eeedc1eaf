"""Walk-on-stars walk step for screened Poisson problems (port of
nmcfluid/wost/solver.py, the parts the fluid's pressure solve runs).

The fluid's case, in 2D and 3D: single-sided walks on a Neumann boundary
with zero boundary data (demo/scene.h:168-200): an analytic box or
channel, a segment soup (jpipe; walks leave through its open ends when a
step lands outside its bounding box) or the 3D cube. No Dirichlet
boundary, Yukawa
screening from the first step and no maximal spheres. `_advance` is one
step of every active lane (walk_on_stars.h:135-329): star radius, uniform
direction with a hemisphere flip on the boundary, ray clip or arc step,
in-ball source sample along the walk direction, Russian roulette on the
direction-sampled Poisson kernel. Settings outside that case raise.
"""
import dataclasses
from functools import lru_cache
from typing import Callable, NamedTuple

import torch

from ..geometry import analytic3d, queries2d
from ..ops import greens2d, greens3d
from ..ops.sampling import unit_sphere_from_u

RADIUS_SHRINK = 0.99  # walk_on_stars.h:9

# walk completion codes (the JAX package's values; its DONE_DIRICHLET = 2
# needs a Dirichlet boundary)
ACTIVE, DONE_RR, DROP_ESCAPED, DROP_MAXLEN = 0, 1, 3, 4


@dataclasses.dataclass(frozen=True)
class WalkSettings:
    """Mirror of zombie::WalkSettings (walk_on_stars.h:679-742) and of the
    JAX package's estimator settings, less its TPU launch guards and the
    settings of walks not ported yet (Dirichlet shell, silhouettes)."""
    min_star_radius: float = 1e-3
    russian_roulette_threshold: float = 0.99
    max_walk_length: int = 10_000
    steps_before_tikhonov: int = 0
    steps_before_maximal_spheres: int = 10_000
    n_walks: int = 500
    ignore_source: bool = False
    solve_double_sided: bool = False
    use_gradient_control_variates: bool = True
    use_gradient_antithetic_variates: bool = True
    fast_rng: bool = True
    # executor: only the generation executor ("gen") is ported
    algo: str = "gen"
    # pairs run with zero control variates before the CVs freeze
    # (walk_on_stars.h:501-506)
    cv_warmup_pairs: int = 16
    adaptive_walks: float = 0.0
    # generation executor: pairs per generation, and the per-walk step
    # cap beyond which a walk is dropped (reference maxWalkLength)
    gen_group_pairs: int = 4
    gen_step_cap: int = 1024


@dataclasses.dataclass(frozen=True, eq=False)
class WostScene:
    """Static PDE + geometry description (zombie::PDE, core/pde.h:14-27).
    `source_fn(x, *source_args)` is the volumetric source. The boundary is
    all Neumann with zero data: the JAX package's Dirichlet boundary and
    boundary-data functions are not ported yet."""
    dim: int
    neumann: object                 # Analytic2D or Seg2D (2D), Box3D (3D)
    source_fn: Callable
    absorption: float = 0.0

    def qmod(self):
        """The query module: queries2d in 2D (a segment soup, or an
        Analytic2D boundary it hands to analytic2d), analytic3d in 3D."""
        return queries2d if self.dim == 2 else analytic3d

    def greens(self):
        return _get_greens(self.dim, float(self.absorption))


@lru_cache(maxsize=None)
def _get_greens(dim: int, absorption: float):
    """One Green's-function object per (dim, sigma): its radius table is
    built once on the host."""
    if absorption <= 0.0:
        raise NotImplementedError(
            "WoSt: only the screened (Yukawa) Green's functions are ported")
    return (greens2d.Yukawa2D if dim == 2 else greens3d.Yukawa3D)(absorption)


def check_supported(scene: WostScene, settings: WalkSettings):
    """Raise for every setting outside the fluid's walk (see module doc)."""
    bad = []
    if settings.algo != "gen":
        bad.append(f"algo={settings.algo!r} (only 'gen')")
    if not settings.fast_rng:
        bad.append("fast_rng=False")
    if settings.adaptive_walks > 0.0:
        bad.append("adaptive_walks")
    if settings.steps_before_tikhonov > 0:
        bad.append("steps_before_tikhonov > 0")
    if settings.steps_before_maximal_spheres < settings.max_walk_length:
        bad.append("maximal spheres")
    if settings.solve_double_sided:
        bad.append("solve_double_sided")
    if settings.ignore_source:
        bad.append("ignore_source")
    if bad:
        raise NotImplementedError("WoSt: not ported yet: " + ", ".join(bad))


class WalkState(NamedTuple):
    x: torch.Tensor            # (..., D) current position
    n: torch.Tensor            # (..., D) current normal (stale unless on bdry)
    on_neumann: torch.Tensor   # (...,) bool
    thr: torch.Tensor          # (...,) throughput
    acc: torch.Tensor          # (...,) accumulated source contribution
    steps: torch.Tensor        # (...,) int64
    status: torch.Tensor       # (...,) int64 completion code
    first_radius: torch.Tensor  # (...,) >0 -> use as first star radius


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
        first_radius=torch.zeros(lanes, dtype=torch.float32, device=dev))
    base.update(over)
    return WalkState(**base)


def _dirichlet_dist(scene, x):
    """Distance to the Dirichlet boundary. The ported scenes have none, so
    this is zombie's fallback: the distance to the far bbox corner
    (fcpw_scene_loader.h:299-315)."""
    return scene.qmod().dist_to_far_bbox_corner(scene.neumann, x)


def _advance(scene, greens, settings: WalkSettings, st: WalkState, draw,
             source_args=(), step_cap=None):
    """One walk step for every ACTIVE lane (walk_on_stars.h:135-329).

    `draw(salt, shape)` supplies the step's uniforms (the caller keys the
    streams). `step_cap` overrides max_walk_length as the DROP_MAXLEN
    threshold."""
    q = scene.qmod()
    rr = settings.russian_roulette_threshold
    soup = scene.neumann
    cap = settings.max_walk_length if step_cap is None else step_cap

    active = st.status == ACTIVE

    dd = _dirichlet_dist(scene, st.x)
    star = q.star_radius(soup, st.x, settings.min_star_radius, dd)
    star = torch.where(settings.min_star_radius <= dd,
                       torch.clamp(RADIUS_SHRINK * star,
                                   min=settings.min_star_radius), star)
    R = torch.where(st.first_radius > 0.0, st.first_radius, star)
    ball = greens.make_ball(R)

    u_dir = torch.stack([draw(s_, R.shape) for s_ in range(scene.dim - 1)],
                        dim=-1)
    d = unit_sphere_from_u(u_dir, scene.dim).expand(st.x.shape)
    flip = st.on_neumann & (torch.sum(st.n * d, -1) > 0.0)
    d = torch.where(flip[..., None], -d, d)

    off = q.OFFSET_EPS * torch.clamp(
        torch.linalg.vector_norm(st.x, dim=-1), min=1.0)[..., None]
    o_eff = torch.where(st.on_neumann[..., None], st.x - st.n * off, st.x)
    hit, t_hit, hit_pt, hit_n = q.ray_intersect(soup, o_eff, d, R)
    arc_pt = o_eff + R[..., None] * d
    new_pt = torch.where(hit[..., None], hit_pt, arc_pt)
    new_n = torch.where(hit[..., None], hit_n, st.n)

    # ---- source term: radius along the walk direction, star-clipped
    u2 = torch.stack([draw(4, R.shape), draw(5, R.shape)], dim=-1)
    r_src, _ = greens.sample_radius_u(ball, u2)
    g_norm = greens.norm(ball)
    y = st.x + r_src[..., None] * d
    take = r_src <= t_hit
    contrib = g_norm * scene.source_fn(y, *source_args)
    acc = st.acc + torch.where(active & take, st.thr * contrib, 0.0)

    escaped = (~hit) & q.outside_bbox(soup, new_pt)

    r_new = torch.linalg.vector_norm(new_pt - st.x, dim=-1)
    thr = st.thr * greens.dspk(ball, r_new)
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
    )
