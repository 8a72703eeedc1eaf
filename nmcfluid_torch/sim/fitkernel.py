"""Fused phase fit: every Adam iteration of a phase on a K-batch pool.

Port of nmcfluid/sim/fitkernel.py. During one phase fit the training data
is fixed and every scene's hard-BC wrapper is affine in the raw network
output, u(x) = A(x) raw(x) + c(x), so a phase fit is exactly

    min_params  sum_i w_i |A_i MLP(x_i) + c_i - target_i|^2 / norm

over a pool of K precomputed minibatches, cycled as batch i % K.

`fused_adam_fit` runs it on a CUDA tensor with the hand-written kernel in
csrc/fitkernel.cu (see its header for the design) and on a CPU tensor with
`reference_adam_fit`, the plain PyTorch twin: the same pool cycling and
the optax Adam formula written out by hand (torch.optim.Adam places eps
differently in floating point).
"""
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models.siren import SirenConfig, apply_siren
from ..utils import cuda_build, spans

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

_SOURCES = ("fitkernel.cu",)
_NT = 256                      # threads per block (.cu)
_T = 32                        # points per tile (.cu)
_WIDE = 4096                   # outputs a pass that take the 4 x 4 products
_SMEM_LIMIT = 227 * 1024       # H100 shared memory a block can use
_CHUNK_MAX = 1024              # Adam slice a block aims for; columns a pass
_COOP_TOO_LARGE = 720          # cudaErrorCooperativeLaunchTooLarge

# launches of the CUDA fit: one persistent kernel per fused_adam_fit call
# on a CUDA tensor, counted when the launch was accepted
launches = 0

# the order of the int64 plan array that fit_run reads (.cu: PlanField)
_PLAN_FIELDS = ("D_in", "D_out", "H", "Lh", "B", "K", "n_iters", "Hp",
                "n_params", "n_tiles", "tiles_per_block", "pass_tiles",
                "n_work", "G", "chunk", "pass_cols", "n_wbuf", "recompute",
                "moments_global", "ld_part", "row_groups", "smem_bytes")
# phases timed by thread 0 of block 0 when asked (.cu: Phase)
PHASES = ("first", "fwd_prod", "fwd_epi", "head", "bwd_wgrad", "bwd_igrad",
          "bwd_first", "wait_d", "adam", "wait_f")


class FitPlan(NamedTuple):
    """Launch plan of the persistent fit kernel (csrc/fitkernel.cu).

    The fit runs as G blocks of _NT threads, all resident at once. Tile t
    holds points [t * _T, (t + 1) * _T) of every batch; block b < n_work
    owns tiles [b * tiles_per_block, ...) and every block owns parameters
    [b * chunk, ...) with their Adam moments (`tiles`, `params`). A block
    takes its tiles pass_tiles at a time through every layer. H is padded
    to Hp, a multiple of 32; a pass of _WIDE outputs (pass points x Hp)
    runs the 4 x 4 products (`wide`). sin and cos of every layer stay in
    shared memory unless `recompute`, which keeps each layer's z in a
    global stash and recomputes them; hidden weights are staged through
    n_wbuf buffers. Each of the n_work partial-gradient rows (and the
    padded parameter buffer) is ld_part floats. A block takes its Adam
    slice in passes of pass_cols columns, summing each over the rows in
    row_groups groups of consecutive rows; its moments stay in shared
    memory unless `moments_global`.
    """
    D_in: int
    D_out: int
    H: int
    Lh: int
    B: int
    K: int
    n_iters: int
    Hp: int
    n_params: int
    n_tiles: int
    tiles_per_block: int
    pass_tiles: int
    n_work: int
    G: int
    chunk: int
    pass_cols: int
    n_wbuf: int
    recompute: bool
    moments_global: bool
    ld_part: int
    row_groups: int
    smem_bytes: int

    def tiles(self, b: int) -> range:
        if b >= self.n_work:
            return range(0)
        t0 = b * self.tiles_per_block
        return range(t0, min(t0 + self.tiles_per_block, self.n_tiles))

    @property
    def wide(self) -> bool:
        return _T * self.pass_tiles * self.Hp == _WIDE

    def params(self, b: int) -> range:
        q0 = min(b * self.chunk, self.n_params)
        return range(q0, min(q0 + self.chunk, self.n_params))

    def array(self) -> np.ndarray:
        return np.array([int(getattr(self, f)) for f in _PLAN_FIELDS],
                        np.int64)


def _smem_bytes(Hp, Lh, chunk, pass_cols, n_wbuf, recompute,
                moments_global, row_groups, pass_tiles):
    """Shared memory of one block (the .cu's smem_layout, in bytes)."""
    pts = _T * pass_tiles
    act = (5 if recompute else 2 * (Lh + 1)) * pts * Hp
    nbuf = n_wbuf if Lh > 0 else 0
    # hidden weights and their biases, first layer, head, the pass's pool
    # data, GR, loss sums
    small = nbuf * (Hp * Hp + Hp) + 4 * Hp + 4 * Hp + 4 + 20 * pts \
        + 4 * pts + 32
    moments = 0 if moments_global else 2 * chunk
    return 4 * (act + small + moments + row_groups * pass_cols)


def fit_plan(D_in, D_out, H, Lh, B, K, n_iters, n_sm, recompute=None,
             pass_tiles=None):
    """The launch plan for a fit on a card with `n_sm` SMs. recompute=None
    keeps sin and cos when they fit (else recomputes them); True or False
    forces the choice. pass_tiles=None takes two tiles a pass where one
    gives half of _WIDE outputs (Hp = 64), the blocks own two or more and
    sin and cos kept fit beside them, else one; 1 or 2 forces it. Raises
    ValueError for what the kernel cannot run: D_in or D_out other than 2
    or 3, H outside 1..128, or a forced choice that does not fit or that
    the kernel does not take."""
    if D_in not in (2, 3) or D_out not in (2, 3) or not 1 <= H <= 128 \
            or Lh < 0 or B < 1 or K < 1 or n_iters < 1 or n_sm < 1:
        raise ValueError(f"fused fit: unsupported shape D_in={D_in} "
                         f"D_out={D_out} H={H} Lh={Lh} B={B} K={K} "
                         f"n_iters={n_iters} n_sm={n_sm}")
    Hp = -(-H // 32) * 32
    n_params = D_in * H + H + Lh * (H * H + H) + H * D_out + D_out
    n_tiles = -(-B // _T)
    tpb = -(-n_tiles // n_sm)
    n_work = -(-n_tiles // tpb)
    G = max(n_work, min(n_sm, -(-n_params // _CHUNK_MAX)))
    chunk = -(-n_params // G)
    chunk = -(-chunk // 4) * 4
    pass_cols = min(chunk, _CHUNK_MAX)
    # enough row groups to give every thread a column of one
    row_groups = max(1, min(n_work, 16, _NT // (pass_cols // 4)))
    # (pass_tiles, recompute, n_wbuf, moments_global), cheapest first; the
    # last fits any depth at H <= 128. Two tiles a pass double the
    # activations, so they come with sin and cos kept only.
    modes = [(1, False, 2, False), (1, False, 1, False), (1, True, 2, False),
             (1, True, 1, False), (1, True, 1, True)]
    if 2 * _T * Hp == _WIDE and tpb >= 2:
        modes = [(2, False, 2, False), (2, False, 1, False)] + modes
    for pt, rc, nb, mg in modes:
        if recompute is not None and rc != recompute \
                or pass_tiles is not None and pt != pass_tiles:
            continue
        smem = _smem_bytes(Hp, Lh, chunk, pass_cols, nb, rc, mg, row_groups,
                           pt)
        if smem <= _SMEM_LIMIT:
            return FitPlan(D_in, D_out, H, Lh, B, K, n_iters, Hp, n_params,
                           n_tiles, tpb, pt, n_work, G, chunk, pass_cols, nb,
                           rc, mg, -(-n_params // 4) * 4, row_groups, smem)
    raise ValueError(f"fused fit: no plan for Lh={Lh}, H={H}, B={B} "
                     f"(recompute={recompute}, pass_tiles={pass_tiles}) "
                     f"fits shared memory")


def iteration_work(cfg: SirenConfig, B: int):
    """(bytes, flops) of one Adam iteration at batch B, the least any
    implementation must move and compute: the SIREN's forward MACs and
    twice as many backward, at 2 flops a MAC; one pool batch (x, A, c,
    target, w) read, and the params, m and v read and written once."""
    H, Lh, D_in, D_out = (cfg.hidden_features, cfg.num_hidden_layers,
                          cfg.in_features, cfg.out_features)
    macs = D_in * H + Lh * H * H + H * D_out
    n_params = macs + (Lh + 1) * H + D_out
    n_bytes = 4 * (B * (D_in + D_out * D_out + 3 * D_out + 1)
                   + 6 * n_params)
    return n_bytes, 2 * 3 * macs * B


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load csrc/fitkernel.cu."""
    return typed(cuda_build.load("fitkernel", _SOURCES))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` with fit_run's and fit_error_string's C signatures set (for
    csrc/fitkernel.cu and the probes' edited copies of it)."""
    if not getattr(lib, "_nmc_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fit_run.argtypes = [P] * 15 + [I, P]
        lib.fit_run.restype = I
        lib.fit_error_string.argtypes = [I]
        lib.fit_error_string.restype = ctypes.c_char_p
        lib._nmc_typed = True
    return lib


def _lr_array(lr, n_iters, device):
    return torch.as_tensor(lr, dtype=torch.float32,
                           device=device).reshape(-1).expand(n_iters)


def _shapes(params, pool):
    x, A, c, tgt, w = pool
    K, B, D_in = x.shape
    D_out = c.shape[-1]
    H = params[0][0].shape[1]
    return K, B, D_in, D_out, H, len(params) - 2


def _check_cuda_inputs(params, cfg, pool):
    """Shapes, device and dtype of a CUDA call (fit_plan checks the
    sizes the kernel takes)."""
    K, B, D_in, D_out, H, Lh = _shapes(params, pool)
    x, A, c, tgt, w = pool
    want = {"x": (K, B, D_in), "A": (K, B, D_out, D_out),
            "c": (K, B, D_out), "target": (K, B, D_out), "w": (K, B)}
    for name, t in zip(want, pool):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused fit: pool {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    dims = [(D_in, H)] + [(H, H)] * Lh + [(H, D_out)]
    for (W, b), (fi, fo) in zip(params, dims):
        if tuple(W.shape) != (fi, fo) or tuple(b.shape) != (fo,):
            raise ValueError("fused fit: parameter shapes do not match "
                             "the SIREN layout")
    dev = x.device
    for t in [*pool] + [a for p in params for a in p]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("fused fit: every tensor must be float32 on "
                             f"{dev}")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cuda_adam_fit(params, cfg, pool, n_iters, lr):
    """fused_adam_fit on the card, with the plan fit_plan chooses."""
    _check_cuda_inputs(params, cfg, pool)
    K, B, D_in, D_out, H, Lh = _shapes(params, pool)
    plan = fit_plan(D_in, D_out, H, Lh, B, K, n_iters,
                    _sm_count(pool[0].device))
    out = run_plan(plan, params, pool, lr)
    # a traced frame's launches that ran the 4 x 4 products (0 counted
    # too, so that a frame of narrow launches reads 0; no sync)
    spans.count("fit_wide_launches", int(plan.wide))
    return out


def run_plan(plan: FitPlan, params, pool, lr, phases=None, lib=None):
    """Launch the fit kernel with `plan` on checked CUDA inputs. phases, if
    given, is a zeroed int64 tensor of len(PHASES) + 2 that receives block
    0's cycles per phase, then the loop's cycles and nanoseconds. lib, if
    given, is a typed library built from an edited copy of the source
    (sim/fitprobe.py's faults) to launch instead."""
    global launches
    lib = lib or load_library()
    dev = pool[0].device
    x, A, c, tgt, w = (t.contiguous() for t in pool)
    # fold the loss normalization into the weights: loss = sum w' r^2
    norm = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0) * plan.D_out
    w_n = (w / norm).contiguous()
    flat = torch.zeros(plan.ld_part, dtype=torch.float32, device=dev)
    torch.cat([t.reshape(-1) for p in params for t in p],
              out=flat[:plan.n_params])
    lr_dev = _lr_array(lr, plan.n_iters, dev).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((plan.n_work, plan.ld_part), **f32)
    loss_part = torch.empty(plan.n_work, **f32)
    loss = torch.empty((), **f32)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    zstash = torch.empty((plan.n_work, (plan.Lh + 1) * _T * plan.Hp),
                         **f32) if plan.recompute else None
    moments = torch.zeros((plan.G, 2, plan.chunk),
                          **f32) if plan.moments_global else None
    arr = plan.array()
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.fit_run(ptr(flat), ptr(x), ptr(A), ptr(c), ptr(tgt),
                         ptr(w_n), ptr(lr_dev), ptr(part), ptr(loss_part),
                         ptr(loss), ptr(barrier), ptr(zstash), ptr(moments),
                         ptr(phases), arr.ctypes.data_as(ctypes.c_void_p),
                         len(arr), ctypes.c_void_p(
                             torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        why = lib.fit_error_string(rc).decode()
        if rc == _COOP_TOO_LARGE:
            why += f" (a grid of {plan.G} blocks cannot be co-resident)"
        raise RuntimeError(f"fit kernel launch failed: CUDA error {rc}, "
                           f"{why}")
    launches += 1
    out, o = [], 0
    for W, b in params:
        nw, nb = W.numel(), b.numel()
        out.append((flat[o:o + nw].view(W.shape),
                    flat[o + nw:o + nw + nb].view(b.shape)))
        o += nw + nb
    return out, loss


def fused_adam_fit(params, cfg: SirenConfig, pool_xactw, n_iters, lr):
    """Run `n_iters` Adam steps on SIREN `params` over a K-batch pool.

    params: list of (W, b) as in models.siren (sine nonlinearity only).
    pool_xactw: (x, A, c, target, w) with x (K, B, D_in), A (K, B, D, D),
        c/target (K, B, D), w (K, B).
    lr: scalar, or an (n_iters,) array of per-iteration learning rates.
    Returns (params, final_loss). A CUDA pool launches the kernel (and
    raises on anything it does not take); a CPU pool runs the plain twin.
    Other nonlinearities raise on both devices: they take the fresh-batch
    fit (sim/fluid.py::_fused_supported), as in the JAX package.
    """
    if cfg.nonlinearity != "sine":
        raise NotImplementedError(
            f"fused fit: nonlinearity {cfg.nonlinearity!r} (only 'sine')")
    if pool_xactw[0].is_cuda:
        return _cuda_adam_fit(params, cfg, pool_xactw, n_iters, lr)
    spans.count("fit_wide_launches", 0)      # the twin launches nothing
    return reference_adam_fit(params, cfg, pool_xactw, n_iters, lr)


def reference_adam_fit(params, cfg: SirenConfig, pool_xactw, n_iters, lr):
    """Plain PyTorch twin of fused_adam_fit (fitkernel.py:455-483): the
    same pool-cycling semantics and optax's Adam, written out."""
    x, A, c, tgt, w = pool_xactw
    K = x.shape[0]
    D_out = c.shape[-1]
    lr_arr = _lr_array(lr, n_iters, x.device)
    p = [(W.detach().clone().requires_grad_(True),
          b.detach().clone().requires_grad_(True)) for W, b in params]
    leaves = [t for pair in p for t in pair]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    b1 = torch.tensor(ADAM_B1, dtype=torch.float32)
    b2 = torch.tensor(ADAM_B2, dtype=torch.float32)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    with torch.enable_grad():
        for i in range(n_iters):
            j = i % K
            raw = apply_siren(p, cfg, x[j])
            u = torch.einsum("nde,ne->nd", A[j], raw) + c[j]
            se = torch.sum((u - tgt[j]) ** 2, dim=-1)
            loss = torch.sum(w[j] * se) / (
                torch.clamp(torch.sum(w[j]), min=1.0) * D_out)
            grads = torch.autograd.grad(loss, leaves)
            bc1 = (1.0 - b1 ** (i + 1)).to(x.device)
            bc2 = (1.0 - b2 ** (i + 1)).to(x.device)
            with torch.no_grad():
                for t, g, mt, vt in zip(leaves, grads, m, v):
                    mt.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
                    vt.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * (g * g))
                    t.sub_(lr_arr[i] * ((mt / bc1)
                                        / (torch.sqrt(vt / bc2) + ADAM_EPS)))
    return [(W.detach(), b.detach()) for W, b in p], loss.detach()
