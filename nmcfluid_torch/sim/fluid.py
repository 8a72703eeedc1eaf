"""The neural Monte Carlo fluid stepper (port of nmcfluid/sim/fluid.py).

Per timestep (model_split.py:44-82), for the ported scenes (Taylor-Green,
the karman family, jpipe and the 3D scenes smoke, smoke_obs,
vortex_collide and karman3d):
    advect:  fit u(x) to u_prev(clamp(x - u_prev(x) dt))
    project: solve (Lap - sigma) p = div(u_prev) at a random pressure
             cloud, then fit u(x) to u_prev(x) - grad p(x)
with `add_source` fitting the initial field once first; adv_ref=True
doubles both phases (advect dt/2, project, MacCormack advect dt/2,
project; model_split.py:63-81). A phase fit runs the fused fit
(sim/fitkernel.py) on a K-batch pool when fit_mode resolves to "fused"
and no knob needs more (`_fused_supported`: a sine net, no parameter EMA,
plateau stop, gradient clip or loss trace), else the fresh-batch Adam
loop (`_adam_fit_single`); both end in the closed-form head solve
(`ls_head`). In scenes with `reset_wts` (the karman family, jpipe and
the 3D scenes) each phase fit starts from fresh weights. On a CUDA device the
fused fit is the hand-written kernel; on the CPU its plain twin. The
divergence grid is 1000^2 in 2D and vis_resolution^3 in 3D. The pressure
solve is the projection: "wost" walks on stars (the reference's Monte
Carlo solve), "spectral" is the DCT box solve with the modal correction
of a circle, cylinder or sphere obstacle (sim/spectral.py, ops/*_modes.py),
"bem" the boundary-element solve of any 2D scene (sim/bem.py) and "bvc"
its Monte Carlo variant, a walk at the boundary cache only (BvcProjector).
The walk runs on the executor walk_settings.algo names: "gen" or "pool";
its source term is the divergence grid's nearest texel (wost_source
"grid", the reference's) or -div u of the network at the sampled point,
by forward mode (wost_source "net"). With a points mesh (a list of
devices, parallel/mesh.py) the pressure chunks' walks split into one
contiguous block of whole chunks a device, walked concurrently, and
their results gather back on the fluid's device; the fits, the
divergence grid, the clouds and the other projections run there.

Randomness walks the JAX package's key tree call for call through a key
object (utils/keys.py), so the JAX-replay key of the tests reproduces a
JAX step. With fit_ensemble N > 1 every phase fit is N fits from the
same start on the folded keys key.fold_in(0x5EED + j), their parameters
averaged (`_adam_fit`); the JAX package measured it as a negative
(error_bem_ens2_r5.txt), and it stays default-off.
"""
import contextlib
import dataclasses
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from .. import get_device
from ..geometry import queries2d, queries3d
from ..models.boundary import apply_boundary
from ..models.siren import (SirenConfig, apply_siren, apply_siren_features,
                            apply_siren_tangents, init_siren)
from ..parallel.mesh import points_mesh, replicate, shard_bounds
from ..utils import spans
from ..utils.keys import Key, KeyGroup
from ..wost.solver import (WalkSettings, WostScene,
                           estimate_solution_and_gradient)
from . import sampling
from .bem import BemProjector, BvcProjector
from .fitkernel import ADAM_B1, ADAM_B2, ADAM_EPS, fused_adam_fit
from .spectral import grid_gradient, solve_screened_poisson


class SimState(NamedTuple):
    """Everything that persists between timesteps: the network weights.
    The JAX package's params_prev and params_tilde equal params outside a
    step and its step reads neither (the MacCormack fit's tilde is the
    step's own first advection fit), so they stay implicit."""
    params: list            # velocity_field
    P: torch.Tensor         # mean pressure (base.py:305)
    eps: float              # boundary ramp width
    timestep: int
    key: object             # key object (utils/keys.py)


class FitStats(NamedTuple):
    iters: int
    loss: torch.Tensor
    # what ran the fit: "fit kernel", "plain twin" (the kernel's CPU
    # version) or "fresh-batch" (_adam_fit_single's loop)
    executor: str
    # the minibatch loss every `loss_trace` iterations (--vis_frequency),
    # or None
    trace: Optional[torch.Tensor] = None


class NeuralFluid:
    """Host-side orchestrator of the phase fits and the pressure solve.

    Takes the JAX package's constructor arguments; the projections the
    JAX package refuses (spectral on a scene whose obstacle is not one
    circle, bem in 3D) raise ValueError. fit_ensemble N > 1 averages N
    fits a phase (`_adam_fit`; default 1, a measured negative in JAX).
    The walk runs on the executor walk_settings names (gen, pool or
    lockstep; adaptive allocation on the pool). wost_source
    ("grid" or "net") is read by the wost projection only, as in JAX (bvc
    walks its cache with the grid). `mesh` is a list of torch devices
    (parallel.points_mesh).
    fit_mode "auto" resolves to "fused" on every device (the JAX package
    picks "xla" on the CPU, where its kernel would run interpreted; the
    port's CPU twin is plain PyTorch). The JAX package's fit_unroll is
    not taken: its results are the same for any value. `device` is
    where every tensor is created: None means the GPU, and raises
    RuntimeError without one; device="cpu" asks for the CPU."""

    def __init__(self, scene, *, max_n_iters: Optional[int] = None,
                 sample_resolution: Optional[int] = None,
                 wost_resolution: Optional[int] = None,
                 div_resolution: Optional[int] = None,
                 n_walks: Optional[int] = None,
                 walk_settings: Optional[WalkSettings] = None,
                 adv_ref: bool = False,
                 projection: str = "wost",
                 lr_schedule: str = "constant",
                 param_ema: float = 0.0,
                 grad_clip: float = -1.0,
                 fit_plateau: int = 0,
                 ls_head: int = 8,
                 fit_mode: str = "auto",
                 fit_pool: int = 512,
                 fit_ensemble: int = 1,
                 loss_trace: int = 0,
                 wost_source: str = "grid",
                 mesh=None,
                 device=None):
        if projection not in ("wost", "spectral", "bem", "bvc"):
            raise ValueError(f"NeuralFluid: unknown projection "
                             f"{projection!r}")
        if (projection == "spectral" and scene.dim == 2
                and scene.has_obstacle and scene.obstacle_center is None):
            # the deterministic box solve needs the fluid domain to be the
            # box minus at most one circle; jpipe's is the pipe's interior
            raise ValueError(
                f"--projection spectral is unsupported on '{scene.name}': "
                "its obstacle is not a circle (use the bem or wost "
                "projection)")
        if projection in ("bem", "bvc") and scene.dim != 2:
            raise ValueError(
                f"--projection {projection} is 2D-only (the 3D scenes' "
                "WoSt domain is the plain cube, where spectral is already "
                "exact)")
        if wost_source not in ("grid", "net"):
            raise ValueError(f"NeuralFluid: unknown wost_source "
                             f"{wost_source!r}")
        if fit_mode not in ("auto", "fused", "xla"):
            raise ValueError(f"NeuralFluid: unknown fit_mode {fit_mode!r}")
        if lr_schedule not in ("constant", "cosine", "tail"):
            raise ValueError(f"NeuralFluid: unknown lr_schedule "
                             f"{lr_schedule!r}")
        self.scene = scene
        self.device = get_device(device)
        self.projection = projection
        self._bem = None        # the BemProjector, built at first use
        self._bvc = None        # the BvcProjector, built at first use
        self.adv_ref = bool(adv_ref)
        self.fit_mode = "fused" if fit_mode == "auto" else fit_mode
        self.lr_schedule = lr_schedule
        self.param_ema = param_ema
        self.grad_clip = grad_clip
        self.fit_plateau = fit_plateau
        self.loss_trace = loss_trace
        self.ls_head = ls_head
        self.fit_pool = fit_pool
        self.fit_ensemble = max(1, int(fit_ensemble))
        self.max_n_iters = max_n_iters or scene.max_n_iters
        self.sample_resolution = sample_resolution or scene.sample_resolution
        self.wost_resolution = wost_resolution or scene.wost_resolution
        # the 2D divergence grid is 1000^2 in the reference
        # (model_split.py:255), the 3D one vis_resolution^3
        # (3d/model_split.py:268)
        self.div_resolution = div_resolution or (
            1000 if scene.dim == 2 else scene.vis_resolution)
        self.n_batch = self.sample_resolution ** 2
        self.n_pressure = self.wost_resolution ** 2
        # 65,536-point chunks: they fix the key tree (one fold_in per chunk)
        # and bound walk memory at 524k lanes per generation
        self.wost_chunk = min(self.n_pressure, 65536)
        self.walk_settings = walk_settings or scene.walk_settings(
            n_walks=n_walks or scene.n_walks)
        self.siren_cfg = SirenConfig(
            scene.dim, scene.dim,
            num_hidden_layers=scene.num_hidden_layers,
            hidden_features=scene.hidden_features,
            nonlinearity=scene.nonlinearity,
            normal_init_std=0.1 if scene.dim == 2 else 1.0)
        self.q = queries2d if scene.dim == 2 else queries3d
        self.boundary = scene.boundary.to(self.device)
        ss = scene.scene_size

        def source_lookup(y, grid):
            return sampling.nearest_lookup(grid, ss, y)

        def source_net(y, prev, eps, t):
            flat = y.reshape(-1, scene.dim)
            return _neg_divergence(self, prev, eps, t, flat).reshape(
                y.shape[:-1])

        self.wost_source = wost_source
        self._wost_scene = WostScene(
            dim=scene.dim, neumann=self.boundary, source_fn=source_lookup,
            absorption=scene.absorption)
        self._wost_scene_net = WostScene(
            dim=scene.dim, neumann=self.boundary, source_fn=source_net,
            absorption=scene.absorption)
        self.mesh = None if mesh is None else points_mesh(devices=mesh)
        if self.mesh and self.n_pressure // self.wost_chunk < len(self.mesh):
            # the mesh walks whole chunks: at least one a device
            self.wost_chunk = max(1, self.n_pressure // len(self.mesh))
        if projection in ("wost", "bvc"):
            # the Green's function's radius table, built once on the host
            self._wost_scene.greens()
        self._bbox_lo = torch.tensor(ss[0::2], dtype=torch.float32,
                                     device=self.device)
        self._bbox_hi = torch.tensor(ss[1::2], dtype=torch.float32,
                                     device=self.device)
        # the key of the hard BCs' draws (smoke's jet jitter): the JAX
        # package's fixed PRNGKey(7), folded with the timestep, not the
        # step's key; init_state makes it of its own key's class
        self.bc_key = Key(7)
        # opt-in per-stage wall-clock breakdown (utils/spans.py): with
        # profile on, step and add_source bind stage_times as the spans'
        # sink, and each stage synchronizes
        self.profile = False
        self.stage_times: dict = {}

    def _traced(self):
        """The spans' binding of a public entry point: stage_times when
        profile is on (read at each call: callers assign a fresh dict
        between calls), else none."""
        return spans.bound(self.stage_times if self.profile else None)

    def _timed(self, name, fn, *args):
        """Run a stage as the span `name`: with profile on, synchronized,
        its wall-clock added to stage_times[name]; under torch.profiler, a
        "stage:<name>" range. A caller that opens the same range around
        this one nests a range of the same name, which reads the same
        under an innermost-range rule."""
        with spans.span(name, self.device):
            return fn(*args)

    # ------------------------------------------------------------- velocity

    def velocity(self, params, x, *, eps, t=0, group_dims=0):
        """query_velocity (base.py:158-224): raw net + scene hard BCs;
        `group_dims` as apply_boundary's."""
        return apply_boundary(self.scene, apply_siren(params, self.siren_cfg,
                                                      x), x, eps=eps, t=t,
                              key=self.bc_key, group_dims=group_dims)

    def velocity_affine(self, x, *, eps, t, group_dims=0):
        """(A, c) with apply_boundary(raw) == A @ raw + c at x:
        A (..., D, D), c (..., D)."""
        dim = self.scene.dim

        def g(raw):
            return apply_boundary(self.scene, raw, x, eps=eps, t=t,
                                  key=self.bc_key, group_dims=group_dims)

        with spans.span("bc_affine"):
            zero = torch.zeros(x.shape[:-1] + (dim,), dtype=torch.float32,
                               device=x.device)
            c = g(zero)
            cols = []
            for d in range(dim):
                e = zero.clone()
                e[..., d] = 1.0
                cols.append(g(e) - c)
            return torch.stack(cols, dim=-1), c

    # ----------------------------------------------------------------- init

    def init_state(self, seed: int = 0, key=None) -> SimState:
        """Random SIREN weights from `seed`, or from a key object `key`
        (the tests pass one that replays jax.random). The hard BCs' key
        becomes seed 7 of the same key class."""
        key = Key(seed) if key is None else key
        self.bc_key = type(key).from_seed(7)
        kp, key = key.split(2)
        params = init_siren(kp, self.siren_cfg, self.device)
        return SimState(params=params, P=torch.zeros((), device=self.device),
                        eps=float(self.scene.bdry_eps), timestep=0, key=key)

    def _phase_init(self, state: SimState, key):
        """Fresh weights when the scene resets them (create_optimizer(
        reset=True), base.py:61-71), else a warm start from the current
        params."""
        if self.scene.reset_wts:
            return init_siren(key, self.siren_cfg, self.device)
        return state.params

    # ------------------------------------------------------------ public API

    def add_source(self, state: SimState) -> SimState:
        """Fit the initial condition (base.py:313-335)."""
        key, k1, _ = state.key.split(3)
        with self._traced():
            params, stats = self._timed("source_fit", _fit_source, self,
                                        state.params, k1, state.eps,
                                        state.timestep)
        self._last_stats = stats
        return state._replace(params=params, key=key)

    def step(self, state: SimState) -> SimState:
        """One operator-split timestep (model_split.py:44-82); with adv_ref
        the reflection variant (:63-81): advect(dt/2), project, MacCormack
        advect(dt/2) against the first advection fit, project."""
        with self._traced():
            return self._step(state)

    def _step(self, state):
        state = state._replace(timestep=state.timestep + 1)
        prev = state.params
        dt = self.scene.dt

        def advect(params_init, prev, tilde, dt, flag, k, name="advect_fit"):
            return self._timed(name, _fit_advect, self, flag, params_init,
                               prev, tilde, dt, k, state.eps, state.timestep)

        if not self.adv_ref:
            key, k1, k2, k3, k4 = state.key.split(5)
            p1, st_a = advect(self._phase_init(state, k1), prev, prev, dt,
                              False, k2)
            out, P, st_p = self._project(state, p1, p1, k3, k4)
            self._last_stats = (st_a, st_p)
        else:
            key, k1, k2, k3, k4, k5, k6, k7, k8 = state.key.split(9)
            p1, st1 = advect(self._phase_init(state, k1), prev, prev, dt / 2,
                             False, k2)
            p2, P, st2 = self._project(state, p1, p1, k3, k4)
            p3, st3 = advect(self._phase_init(state, k5), p2, p1, dt / 2,
                             True, k6, name="advect_fit2")
            out, P, st4 = self._project(state, p3, p3, k7, k8,
                                        fit_name="project_fit2")
            self._last_stats = (st1, st2, st3, st4)
        return state._replace(params=out, P=P, key=key)

    def _project(self, state, params_init, prev, k_wost, k_fit,
                 fit_name="project_fit"):
        """Pressure solve + projection fit (model_split.py:245-284)."""
        div_grid = self._timed("div_grid", _divergence_grid, self, prev,
                               state.eps, state.timestep)
        if self.projection == "spectral":
            pts, valid, p, grad_p = self._timed(
                "spectral_solve", _pressure_solve_spectral, self, div_grid,
                k_wost)
        elif self.projection == "bem":
            if self._bem is None:
                self._bem = self._timed(
                    "bem_precompute", lambda: BemProjector(
                        self.scene, self.div_resolution,
                        device=self.device))
            pts, valid, p, grad_p = self._timed(
                "bem_solve", _pressure_solve_bem, self, self._bem, div_grid,
                k_wost)
        elif self.projection == "bvc":
            if self._bvc is None:
                self._bvc = self._timed(
                    "bvc_precompute", lambda: BvcProjector(
                        self.scene, self.div_resolution, self._wost_scene,
                        self.walk_settings, device=self.device))
            pts, valid, p, grad_p = self._timed(
                "bvc_solve", _pressure_solve_bvc, self, self._bvc, div_grid,
                k_wost)
        else:
            if self.wost_source == "net":
                wsc, sargs = self._wost_scene_net, (prev, state.eps,
                                                    state.timestep)
            else:
                wsc, sargs = self._wost_scene, (div_grid,)
            pts, valid, p, grad_p = _pressure_solve_wost(self, sargs,
                                                         k_wost, wsc)
        self._last_projection = (pts, p, grad_p, div_grid)
        P = torch.mean(p)     # model_split.py:219
        if self.scene.reset_wts:
            # the JAX package draws the reset weights from fold_in(k_fit,
            # 1), the key of the fit's pool batch 1 (reproduced, not fixed)
            params_init = self._phase_init(state, k_fit.fold_in(1))
        params, stats = self._timed(
            fit_name, _fit_project, self, params_init, prev, pts,
            grad_p, k_fit, state.eps, state.timestep)
        return params, P, stats

    # ------------------------------------------------------------- measures

    def sample_velocity_grid(self, state, resolution, with_boundary=True):
        """The velocity on a uniform grid (base.py:253-265)."""
        return _velocity_grid(self, state.params, state.eps, state.timestep,
                              resolution, with_boundary)

    def kinetic_energy(self, state, resolution=None):
        """0.5 mean u^2 + P over the cell-centered vel_vis grid
        (base.py:303-306; the mean runs over both components)."""
        res = resolution or self.scene.vel_vis_resolution
        u = _velocity_grid(self, state.params, state.eps, state.timestep,
                           res, False)
        return 0.5 * torch.mean(u ** 2) + state.P


def _velocity_grid(fluid, params, eps, t, resolution, with_boundary):
    """The velocity (hard BCs applied) on the scene's uniform grid."""
    pts = sampling.uniform_grid(fluid.scene.scene_size, resolution,
                                with_boundary, device=fluid.device)
    with torch.no_grad():
        return fluid.velocity(params, pts, eps=eps, t=t)


# ------------------------------------------------------------ phase fits


def _adam_fit(fluid, params0, key, batch_fn):
    """A phase fit (fluid.py:459-478): _adam_fit_single, or with
    fit_ensemble N > 1, N of them from the same start params0 on the keys
    key.fold_in(0x5EED + j), their parameters averaged leaf by leaf; the
    stats carry the first fit's iters and trace, the mean loss and the
    executor of the single fit."""
    n_ens = fluid.fit_ensemble
    if n_ens == 1:
        return _adam_fit_single(fluid, params0, key, batch_fn)
    outs = [_adam_fit_single(fluid, params0, key.fold_in(0x5EED + j),
                             batch_fn) for j in range(n_ens)]
    params = [tuple(sum(leaves) / float(n_ens) for leaves in zip(*layers))
              for layers in zip(*(p for p, _ in outs))]
    first = outs[0][1]
    return params, first._replace(
        loss=sum(s.loss for _, s in outs) / float(n_ens))


def _adam_fit_single(fluid, params0, key, batch_fn):
    """One phase fit (fluid.py:481-605): the fused fit when fit_mode is
    "fused" and `_fused_supported`, else the fresh-batch Adam loop, the
    reference's _training_loop (base.py:129-152): a fresh minibatch from
    key.fold_in(i) every iteration, optax's Adam (after optax's global-norm
    clip when grad_clip > 0) with the lr schedule, until max_n_iters or
    the loss is <= early_stop_loss; param_ema returns the Polyak average
    (exact tracking until 80% of max_n_iters); fit_plateau stops at the
    end of a window that improved the smoothed loss by < 0.5%; loss_trace
    records the loss every N iterations. Then ls_head.

    Each iteration is JAX's predicated step: `live` is a device flag and a
    dead iteration changes nothing, so the count of live iterations is
    JAX's. The host reads the flag every _STOP_CHECK iterations only, to
    leave the loop early without a sync each iteration."""
    if fluid.fit_mode == "fused" and _fused_supported(fluid):
        return _fused_fit(fluid, params0, key, batch_fn)
    n, dim = fluid.max_n_iters, fluid.scene.dim
    tol = fluid.scene.early_stop_loss
    gamma, plateau, every = (fluid.param_ema, fluid.fit_plateau,
                             fluid.loss_trace)
    ema_start = int(n * 0.8)
    p_decay, p_rel = 1.0 - 2.0 / max(2, plateau), 5e-3
    lr = _fit_lr_array(fluid)
    lrs = lr.tolist() if isinstance(lr, torch.Tensor) else [lr] * n
    leaves = [t for pair in params0 for t in pair]
    sizes = [t.numel() for t in leaves]

    def unflat(flat):
        parts = [p.view(t.shape) for p, t in zip(flat.split(sizes), leaves)]
        return list(zip(parts[0::2], parts[1::2]))

    flat = torch.cat([t.reshape(-1) for t in leaves])
    ema = flat
    m, v = torch.zeros_like(flat), torch.zeros_like(flat)
    bc1s, bc2s = adam_bias_corrections(n)
    dev = flat.device
    count = torch.zeros((), dtype=torch.int64, device=dev)
    loss = torch.full((), math.inf, device=dev)
    trace = (torch.zeros(-(-n // every), device=dev) if every else None)
    ema_loss = ref_loss = loss
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(n):
        live = (loss > tol) & ~stop
        if i % _STOP_CHECK == 0 and i > 0 and not bool(live):
            break
        x, target, w = batch_fn.batch(key.fold_in(i))
        with torch.enable_grad():
            p = flat.detach().requires_grad_(True)
            new_loss = _batch_loss(batch_fn, unflat(p), x, target, w, dim)
            g, = torch.autograd.grad(new_loss, p)
        new_loss = new_loss.detach()
        if fluid.grad_clip > 0.0:
            # optax.clip_by_global_norm: the norm summed leaf by leaf
            norm = torch.sqrt(sum(torch.sum(gl * gl) for gl in g.split(sizes)))
            g = torch.where(norm < fluid.grad_clip, g,
                            (g / norm) * fluid.grad_clip)
        new_flat, new_m, new_v = adam_update(flat, m, v, g, lrs[i], bc1s[i],
                                             bc2s[i])
        if gamma > 0.0:
            new_ema = (gamma * ema + (1.0 - gamma) * new_flat
                       if i >= ema_start else new_flat)
            ema = torch.where(live, new_ema, ema)
        flat = torch.where(live, new_flat, flat)
        m = torch.where(live, new_m, m)
        v = torch.where(live, new_v, v)
        loss = torch.where(live, new_loss, loss)
        count = count + live.to(torch.int64)
        if every and i % every == 0:
            trace[i // every] = torch.where(live, new_loss, trace[i // every])
        if plateau > 0:
            new_ema_loss = (new_loss if i == 0 else
                            p_decay * ema_loss + (1.0 - p_decay) * new_loss)
            if (i + 1) % plateau == 0:
                flat_window = new_ema_loss >= ref_loss * (1.0 - p_rel)
                stop = torch.where(live, flat_window, stop)
                ref_loss = torch.where(live, new_ema_loss, ref_loss)
            ema_loss = torch.where(live, new_ema_loss, ema_loss)
    out = unflat(ema if gamma > 0.0 else flat)
    if fluid.ls_head > 0:
        out = _ls_head_solve(fluid, out, key, batch_fn)
    return out, FitStats(iters=int(count), loss=loss, trace=trace,
                         executor="fresh-batch")


# iterations between the fresh-batch loop's host reads of its stop flag
_STOP_CHECK = 32


def adam_bias_corrections(n):
    """optax Adam's bias corrections 1 - b^(i+1) for i < n, computed in
    float32, as host scalars."""
    steps = torch.arange(1, n + 1)
    return ((1.0 - torch.tensor(ADAM_B1) ** steps).tolist(),
            (1.0 - torch.tensor(ADAM_B2) ** steps).tolist())


def adam_update(flat, m, v, g, lr, bc1, bc2):
    """One optax Adam update (scale_by_adam, then -lr) of the flat
    parameters by the gradient g, in optax's order of operations; lr is a
    number or a 0-d tensor. Returns (flat, m, v)."""
    m = (1.0 - ADAM_B1) * g + ADAM_B1 * m
    v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
    return flat - lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)), m, v


def _fused_supported(fluid):
    """Feature gate of the fused fit (fluid.py:608-632): no parameter EMA,
    plateau stop, gradient clipping or loss trace, and a sine network."""
    return (fluid.param_ema == 0.0 and fluid.fit_plateau == 0
            and fluid.grad_clip <= 0.0 and fluid.loss_trace == 0
            and fluid.siren_cfg.nonlinearity == "sine")


def _cosine_decay(lr, decay_steps, alpha, count):
    """optax.cosine_decay_schedule(lr, decay_steps, alpha) at int64 counts,
    in float32."""
    t = torch.clamp(count, max=decay_steps).to(torch.float32)
    decay = 0.5 * (1.0 + torch.cos(math.pi * t / float(decay_steps)))
    return lr * ((1.0 - alpha) * decay + alpha)


def _fit_lr_array(fluid):
    """Per-iteration learning rates of the lr schedule (fluid.py:635-650):
    the scene's lr as a scalar when constant, else an (n_iters,) array."""
    lr, n = float(fluid.scene.lr), fluid.max_n_iters
    if fluid.lr_schedule == "constant":
        return lr
    i = torch.arange(n)
    if fluid.lr_schedule == "cosine":
        return _cosine_decay(lr, n, 0.01, i)
    # "tail": constant for 80% of the fit, then a cosine decay
    hold = int(n * 0.8)
    return torch.where(i < hold, torch.tensor(lr, dtype=torch.float32),
                       _cosine_decay(lr, max(1, n - hold), 0.02, i - hold))


# points a grouped pass of the pool build holds, and points times
# primitives where the scene's boundary is a segment or triangle soup
# (its queries hold a (points, P, D) tensor)
_POOL_POINTS = 1 << 21
_POOL_PAIRS = 1 << 25


def _pool_group(fluid):
    """Batches a grouped pass of the pool build takes: as many as
    _POOL_POINTS points hold, and _POOL_PAIRS point-primitive pairs of a
    soup boundary, at least one."""
    cap = _POOL_POINTS // fluid.n_batch
    soup = fluid.boundary
    if isinstance(soup, (queries2d.Seg2D, queries3d.Tri3D)):
        cap = min(cap, _POOL_PAIRS // (fluid.n_batch * soup.n.shape[0]))
    return max(1, min(fluid.fit_pool, cap))


def _build_pool(fluid, key, batch_fn, group):
    """The pool (x, A, c, target, w), (K, B, ...), batch i from the key
    key.fold_in(i), i < K = fit_pool, built `group` batches a pass
    (`batch_fn.batches`) into preallocated tensors; each pass adds one to
    the span sink's "pool_passes"."""
    K = fluid.fit_pool
    pool = None
    for i in range(0, K, group):
        spans.count("pool_passes")
        # keys disjoint from ls_head's fold_in(key, max_n_iters + 1 + j)
        x, target, w = batch_fn.batches(
            [key.fold_in(j) for j in range(i, min(i + group, K))])
        out = (x,) + batch_fn.affine(x) + (target, w)
        if pool is None:
            pool = tuple(torch.empty((K,) + a.shape[1:], dtype=a.dtype,
                                     device=a.device) for a in out)
        for p, a in zip(pool, out):
            p[i:i + a.shape[0]] = a
    return pool


def _fused_fit(fluid, params0, key, batch_fn):
    """Phase fit on a pool of K minibatches (fluid.py:653-685): build the
    pool (x, A, c, target, w) from keys fold_in(key, i), i < K, in grouped
    passes (_build_pool, the JAX package's lax.map over batches), run the
    fused fit, then the closed-form head solve."""
    with spans.span("pool_build", fluid.device):
        pool = _build_pool(fluid, key, batch_fn, _pool_group(fluid))
    # with profile on, the fit's own device time (CUDA events) goes to
    # stage_times["fit_kernel"], apart from the pool build and head solve
    timed = fluid.profile and pool[0].is_cuda
    if timed:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    params, loss = fused_adam_fit(params0, fluid.siren_cfg, pool,
                                  fluid.max_n_iters, _fit_lr_array(fluid))
    if timed:
        ev[1].record()
        ev[1].synchronize()
        fluid.stage_times["fit_kernel"] = (
            fluid.stage_times.get("fit_kernel", 0.0)
            + ev[0].elapsed_time(ev[1]) / 1e3)
    if fluid.ls_head > 0:
        params = _ls_head_solve(fluid, params, key, batch_fn)
    return params, FitStats(
        iters=fluid.max_n_iters, loss=loss,
        executor="fit kernel" if pool[0].is_cuda else "plain twin")


def _batch_loss(batch_fn, params, x, target, w, dim):
    u = batch_fn.velocity(params, x)
    se = torch.sum((u - target) ** 2, dim=-1)
    return torch.sum(w * se) / (torch.clamp(torch.sum(w), min=1.0) * dim)


def _ls_head_solve(fluid, params, key, batch_fn):
    """Closed-form finish of the phase fit (fluid.py:688-752): solve the
    final linear layer by weighted least squares over `fluid.ls_head`
    fresh minibatches with the trunk fixed, in delta form, by an
    eigendecomposition with a 1e-5 relative cutoff; keep the Adam endpoint
    when a fresh batch says the solve did not help."""
    W, b = params[-1]
    dim = fluid.scene.dim
    h1 = W.shape[0] + 1                       # features + bias column
    dev = W.device
    with spans.span("head_solve", fluid.device), torch.no_grad():
        M = torch.zeros((h1, dim, h1, dim), dtype=torch.float32, device=dev)
        rhs = torch.zeros((h1, dim), dtype=torch.float32, device=dev)
        for j in range(fluid.ls_head):
            kb = key.fold_in(fluid.max_n_iters + 1 + j)
            x, target, w = batch_fn.batch(kb)
            phi = batch_fn.features(params, x)
            phi1 = torch.cat([phi, torch.ones_like(phi[..., :1])], -1)
            A, _ = batch_fn.affine(x)
            y = target - batch_fn.velocity(params, x)   # residual
            G = torch.einsum("nde,ndf->nef", A, A)
            Ay = torch.einsum("nde,nd->ne", A, y)
            for e in range(dim):
                rhs[:, e] += phi1.T @ (w * Ay[:, e])
                for f in range(dim):
                    M[:, e, :, f] += (phi1 * (w * G[:, e, f])[:, None]).T \
                        @ phi1
        n = h1 * dim
        evals, evecs = torch.linalg.eigh(M.reshape(n, n))
        lmax = torch.clamp(evals[-1], min=1e-30)
        inv = torch.where(evals > 1e-5 * lmax,
                          1.0 / torch.maximum(evals, 1e-5 * lmax),
                          torch.zeros_like(evals))
        delta = (evecs @ (inv * (evecs.T @ rhs.reshape(n)))).reshape(h1, dim)
        cand = params[:-1] + [(W + delta[:-1], b + delta[-1])]
        kb = key.fold_in(fluid.max_n_iters + 1 + fluid.ls_head)
        x, target, w = batch_fn.batch(kb)
        better = bool(_batch_loss(batch_fn, cand, x, target, w, dim)
                      <= _batch_loss(batch_fn, params, x, target, w, dim))
    return cand if better else params


class _PhaseBatches:
    """The batch function of one phase fit: `batch(key)` -> (x, target,
    w), `batches(keys)` -> their (G, B, ...) stacks, plus the velocity,
    features and affine hard-BC map at fixed eps and t. A batch's x is
    (B, D); the axes before those index the batches of a group. By
    default batches() builds the batches one by one; the advection and
    projection phases build them in one pass, their batch() taking a
    KeyGroup."""

    def __init__(self, fluid, eps, t):
        self.fluid, self.eps, self.t = fluid, eps, t

    def batches(self, keys):
        return tuple(torch.stack(a) for a in zip(*map(self.batch, keys)))

    def velocity(self, params, x):
        return self.fluid.velocity(params, x, eps=self.eps, t=self.t,
                                   group_dims=x.dim() - 2)

    def features(self, params, x):
        return apply_siren_features(params, self.fluid.siren_cfg, x)

    def affine(self, x):
        return self.fluid.velocity_affine(x, eps=self.eps, t=self.t,
                                          group_dims=x.dim() - 2)

    def points(self, kb):
        f = self.fluid
        pts, valid = sampling.training_points(
            kb, f.n_batch, f.scene, f.scene.sample_pattern,
            f.sample_resolution, device=f.device)
        return pts, valid.to(torch.float32)


class _SourceBatches(_PhaseBatches):
    def batch(self, kb):
        k1, k2 = kb.split(2)
        pts, w = self.points(k1)
        with spans.span("fit_targets"):
            return pts, self.fluid.scene.source_velocity(pts, key=k2), w


class _AdvectBatches(_PhaseBatches):
    """flag=True is the MacCormack target 2 u_prev - u_tilde at the back
    trace (model_split.py:106)."""

    def __init__(self, fluid, flag, prev, tilde, dt, eps, t):
        super().__init__(fluid, eps, t)
        self.flag, self.prev, self.tilde, self.dt = flag, prev, tilde, dt

    def batch(self, kb):
        f = self.fluid
        pts, w = self.points(kb)
        with spans.span("fit_targets"):
            u_prev = self.velocity(self.prev, pts)
            back = torch.clamp(pts - u_prev * self.dt, f._bbox_lo,
                               f._bbox_hi)          # model_split.py:99-100
            adv = self.velocity(self.prev, back)
            if self.flag:
                adv = 2.0 * adv - self.velocity(self.tilde, back)
        return pts, adv, w

    def batches(self, keys):
        return self.batch(KeyGroup(keys))


class _ProjectBatches(_PhaseBatches):
    def __init__(self, fluid, prev, cloud, grad_p, eps, t):
        super().__init__(fluid, eps, t)
        self.prev, self.cloud, self.grad_p = prev, cloud, grad_p

    def batch(self, kb):
        f = self.fluid
        idx = kb.randint((f.n_batch,), 0, self.cloud.shape[0], f.device)
        pts = self.cloud[idx]
        with spans.span("fit_targets"):
            target = self.velocity(self.prev, pts) - self.grad_p[idx]
            return pts, target, torch.ones(idx.shape, device=f.device)

    def batches(self, keys):
        return self.batch(KeyGroup(keys))


def _fit_source(fluid, params0, key, eps, t):
    """_add_source (base.py:313-335): fit u to the scene's initial field."""
    with torch.no_grad():
        return _adam_fit(fluid, params0, key,
                         _SourceBatches(fluid, eps, t))


def _fit_advect(fluid, flag, params0, prev, tilde, dt, key, eps, t):
    """_advect_velocity (model_split.py:87-120): semi-Lagrangian fit;
    flag=True is the MacCormack correction against tilde."""
    with torch.no_grad():
        return _adam_fit(fluid, params0, key,
                         _AdvectBatches(fluid, flag, prev, tilde, dt, eps,
                                        t))


def _fit_project(fluid, params0, prev, pressure_pts, grad_p, key, eps, t):
    """Projection fit (model_split.py:274-284): minibatch the fixed
    pressure cloud, target u_prev - grad p."""
    with torch.no_grad():
        return _adam_fit(fluid, params0, key,
                         _ProjectBatches(fluid, prev, pressure_pts, grad_p,
                                         eps, t))


# ----------------------------------------------------- projection stages

_DIV_CHUNK = 1 << 18


# forward-mode AD levels are process-wide: the mesh's walk threads take
# turns in the net source's forward passes
_JVP_LOCK = threading.Lock()


def _neg_divergence(fluid, prev, eps, t, flat):
    """-div u_prev (hard BCs included) at points flat (M, D), any M, by
    forward mode: the network's Jacobian written out
    (apply_siren_tangents), then one dual pass of the hard BCs over D
    stacked copies of the points, copy d carrying the tangent of axis d
    (of the raw velocity and of x), in chunks of _DIV_CHUNK lanes."""
    D = fluid.scene.dim
    eye = torch.eye(D, device=flat.device)
    out = [torch.zeros(0, device=flat.device)]
    with torch.no_grad(), _JVP_LOCK, fwAD.dual_level():
        for x in flat.split(_DIV_CHUNK // D):
            M = x.shape[0]
            raw, draw = apply_siren_tangents(prev, fluid.siren_cfg, x)
            u = apply_boundary(
                fluid.scene, fwAD.make_dual(raw.repeat(D, 1),
                                            draw.reshape(D * M, D)),
                fwAD.make_dual(x.repeat(D, 1), eye.repeat_interleave(M, 0)),
                eps=eps, t=t, key=fluid.bc_key)
            du = fwAD.unpack_dual(u).tangent.reshape(D, M, D)
            div = du[0, :, 0]
            for d in range(1, D):
                div = div + du[d, :, d]
            out.append(-div)
    return torch.cat(out)


def _divergence_grid(fluid, prev, eps, t):
    """-div u_prev on the cell-centered div_resolution^dim grid
    (_neg_divergence); the negation matches 'WoSt solves lap u = -f'
    (model_split.py:233)."""
    pts = sampling.uniform_grid(fluid.scene.scene_size, fluid.div_resolution,
                                False, device=fluid.device)
    return _neg_divergence(fluid, prev, eps, t, pts.reshape(
        -1, fluid.scene.dim)).reshape(pts.shape[:-1])


def _sample_pressure_cloud(fluid, key):
    return sampling.fluid_points(key, fluid.wost_chunk, fluid.scene,
                                 device=fluid.device)


def _mask_pressure(fluid, pts, valid, p, grad_p):
    """The reference's boundary masking (grid.h:155-237): p and grad p are
    zeroed within boundary_distance_mask of the boundary; grad p also
    outside the domain."""
    scene = fluid.scene
    dist = fluid.q.distance(fluid.boundary, pts)
    signed = fluid.q.signed_distance(fluid.boundary, pts)
    mask_near = torch.abs(dist) < scene.boundary_distance_mask
    p = torch.where(mask_near, 0.0, p)
    bad = mask_near | (signed >= 0.0) | ~valid
    grad_p = torch.where(bad[:, None], 0.0, grad_p)
    return p, grad_p


def _pressure_solve_wost(fluid, source_args, key, wsc):
    """The walk-on-stars pressure solve: n_pressure // wost_chunk chunks,
    chunk c on key.fold_in(c), each timed as "wost_solve"; over the
    points mesh when there is one (_pressure_solve_mesh). Returns (pts,
    valid, p, grad_p), the chunks concatenated."""
    keys = [key.fold_in(c)
            for c in range(fluid.n_pressure // fluid.wost_chunk)]
    if fluid.mesh is None:
        chunks = [fluid._timed("wost_solve", _pressure_solve, fluid,
                               source_args, k, wsc) for k in keys]
    else:
        chunks = fluid._timed("wost_solve", _pressure_solve_mesh, fluid,
                              source_args, keys, wsc)
    return tuple(torch.cat(xs) for xs in zip(*chunks))


def _pressure_solve(fluid, source_args, key, wsc=None):
    """One chunk: pressure cloud + WoSt solution/gradient, masked. `wsc`
    is the grid-source WostScene (the default) or the net-source one, and
    `source_args` its source's arguments."""
    wsc = fluid._wost_scene if wsc is None else wsc
    k1, k2 = key.split(2)
    pts, valid = _sample_pressure_cloud(fluid, k1)
    with torch.no_grad():
        p, grad_p, _ = estimate_solution_and_gradient(
            wsc, fluid.walk_settings, pts, k2, source_args=source_args)
    return (pts, valid) + _mask_pressure(fluid, pts, valid, p, grad_p)


def _pressure_solve_mesh(fluid, source_args, keys, wsc):
    """The chunks of keys over the points mesh, each chunk the one of
    _pressure_solve: the clouds drawn and the results masked on the
    fluid's device, the walks in one contiguous block of whole chunks a
    device (parallel.mesh.shard_bounds) with the scene's boundary and the
    source's tensors replicated there, one host thread a device (the
    executors sync the host every step), on a CUDA device on a stream of
    its own, so that a thread's syncs wait for its own work only. Every
    walk is the meshless one on the same key, so on one device type the
    solve equals the meshless one bit for bit."""
    mesh = fluid.mesh
    clouds = []
    for key in keys:
        k1, k2 = key.split(2)
        clouds.append((k2,) + _sample_pressure_cloud(fluid, k1))
    reps = replicate(mesh, source_args)
    blocks = shard_bounds(len(keys), mesh)

    def walk(k):
        dev, (a, b) = mesh[k], blocks[k]
        scene = dataclasses.replace(wsc, neumann=wsc.neumann.to(dev))
        out = []
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.no_grad())
            if dev.type == "cuda":
                ctx.enter_context(torch.cuda.device(dev))
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.default_stream(dev))
                ctx.enter_context(torch.cuda.stream(side))
            for key, pts, _ in clouds[a:b]:
                p, g, _ = estimate_solution_and_gradient(
                    scene, fluid.walk_settings, pts.to(dev), key,
                    source_args=tuple(reps[k]))
                out.append((p, g))
            if dev.type == "cuda":
                side.synchronize()
        return out

    with ThreadPoolExecutor(max_workers=len(mesh)) as ex:
        walks = [w for ws in ex.map(walk, range(len(mesh))) for w in ws]
    # the results' memory belongs to their streams' pools: keep it from
    # reuse until the gathers below have run
    for t in (t for w in walks for t in w if t.is_cuda):
        t.record_stream(torch.cuda.current_stream(t.device))
    return [(pts, valid) + _mask_pressure(fluid, pts, valid,
                                          p.to(fluid.device),
                                          g.to(fluid.device))
            for (_, pts, valid), (p, g) in zip(clouds, walks)]


def _pressure_solve_bem(fluid, bp, div_grid, key):
    """The deterministic boundary-element projection (sim/bem.py) at a
    pressure cloud of n_pressure points drawn with `key` in one draw, with
    the walk's boundary masking."""
    pts, valid = sampling.fluid_points(key, fluid.n_pressure, fluid.scene,
                                       device=fluid.device)
    p, grad_p = bp.solve(div_grid, pts)
    return (pts, valid) + _mask_pressure(fluid, pts, valid, p, grad_p)


def _pressure_solve_bvc(fluid, bp, div_grid, key):
    """The boundary-value-caching projection (BvcProjector): the walk at
    the boundary cache only, the splat to a pressure cloud of n_pressure
    points drawn with the first split of `key` (the walk takes the
    second), with the walk's boundary masking. With profile on, the walk
    and the splat add their seconds to stage_times["bvc_walk"] and
    ["bvc_splat"]."""
    k1, k2 = key.split(2)
    pts, valid = sampling.fluid_points(k1, fluid.n_pressure, fluid.scene,
                                       device=fluid.device)
    with torch.no_grad():
        p, grad_p = bp.solve(div_grid, pts, k2, times=(
            fluid.stage_times if fluid.profile else None))
    return (pts, valid) + _mask_pressure(fluid, pts, valid, p, grad_p)


def _pressure_solve_spectral(fluid, div_grid, key):
    """The deterministic DCT projection (sim/spectral.py) of the same
    divergence grid, sampled bilinearly at a pressure cloud of n_pressure
    points drawn with `key` in one draw, with the walk's boundary masking.
    Where the scene has one circle (karman), a cylinder along y (karman3d)
    or a sphere (smoke_obs) and sigma > 0, a modal correction cancels the
    box solve's Neumann residual on the obstacle."""
    scene = fluid.scene
    ss = scene.scene_size
    pts, valid = sampling.fluid_points(key, fluid.n_pressure, scene,
                                       device=fluid.device)
    p_grid = solve_screened_poisson(div_grid, ss, scene.absorption)
    g_grid = grid_gradient(p_grid, ss)
    p = sampling.bilinear_lookup(p_grid, ss, pts)
    grad_p = torch.stack([sampling.bilinear_lookup(g_grid[..., i], ss, pts)
                          for i in range(scene.dim)], -1)
    if (scene.obstacle_center is not None
            and scene.obstacle_radius is not None
            and scene.absorption > 0.0):
        args = (scene.obstacle_center, scene.obstacle_radius,
                scene.absorption)
        if scene.dim == 2:
            from ..ops.circle_modes import (eval_circle_correction,
                                            fit_circle_correction)
            coeffs = fit_circle_correction(g_grid, ss, *args)
            q, grad_q = eval_circle_correction(coeffs, pts, *args)
        elif scene.obstacle_axis == "y":      # karman3d's cylinder
            from ..ops.cylinder_modes import (eval_cylinder_correction,
                                              fit_cylinder_correction)
            coeffs = fit_cylinder_correction(g_grid, ss, *args)
            q, grad_q = eval_cylinder_correction(coeffs, pts, ss, *args)
        else:                                 # smoke_obs's sphere
            from ..ops.sphere_modes import (eval_sphere_correction,
                                            fit_sphere_correction)
            coeffs = fit_sphere_correction(g_grid, ss, *args)
            q, grad_q = eval_sphere_correction(coeffs, pts, *args)
        p = p + q
        grad_p = grad_p + grad_q
    return (pts, valid) + _mask_pressure(fluid, pts, valid, p, grad_p)
