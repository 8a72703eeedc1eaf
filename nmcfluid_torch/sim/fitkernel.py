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

import numpy as np
import torch

from ..models.siren import SirenConfig, apply_siren
from ..utils import cuda_build

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

_SOURCES = ("fitkernel.cu",)
_NT, _MAXR = 256, 8            # threads per block, outputs per thread (.cu)
_SMEM_LIMIT = 227 * 1024       # H100 shared memory a block can use

# launches of the CUDA fit (one per fused_adam_fit call on a CUDA tensor;
# each runs 2 * n_iters kernels)
launches = 0


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load csrc/fitkernel.cu."""
    lib = cuda_build.load("fitkernel", _SOURCES)
    if not getattr(lib, "_nmc_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fit_run.argtypes = [P] * 11 + [I] * 8 + [P]
        lib.fit_run.restype = I
        lib.fit_smem_bytes.argtypes = [I] * 5
        lib.fit_smem_bytes.restype = ctypes.c_longlong
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


def _check_cuda_inputs(params, cfg, pool, n_iters):
    if cfg.nonlinearity != "sine":
        raise NotImplementedError(
            f"fused fit: nonlinearity {cfg.nonlinearity!r} (only 'sine')")
    K, B, D_in, D_out, H, Lh = _shapes(params, pool)
    if D_in not in (2, 3) or D_out not in (2, 3) or not 1 <= H <= 128 \
            or Lh < 0 or n_iters < 1:
        raise ValueError(f"fused fit: unsupported shape D_in={D_in} "
                         f"D_out={D_out} H={H} Lh={Lh} n_iters={n_iters}")
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


def _tile(lib, D_in, D_out, H, Lh):
    """Points per block: T * H <= _NT * _MAXR, shared memory in limit."""
    T = 1
    while 2 * T * H <= _NT * _MAXR and T < 64:
        T *= 2
    while T > 1 and lib.fit_smem_bytes(D_in, D_out, H, Lh, T) > _SMEM_LIMIT:
        T //= 2
    if lib.fit_smem_bytes(D_in, D_out, H, Lh, T) > _SMEM_LIMIT:
        raise ValueError(f"fused fit: Lh={Lh}, H={H} exceeds shared memory")
    return T


def _cuda_adam_fit(params, cfg, pool, n_iters, lr):
    global launches
    _check_cuda_inputs(params, cfg, pool, n_iters)
    lib = load_library()
    K, B, D_in, D_out, H, Lh = _shapes(params, pool)
    x, A, c, tgt, w = (t.contiguous() for t in pool)
    # fold the loss normalization into the weights: loss = sum w' r^2
    norm = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0) * D_out
    w_n = (w / norm).contiguous()
    flat = torch.cat([t.reshape(-1) for p in params for t in p]).contiguous()
    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    T = _tile(lib, D_in, D_out, H, Lh)
    n_blocks = -(-B // T)
    part = torch.empty((n_blocks, flat.numel() + 1), dtype=torch.float32,
                       device=flat.device)
    loss = torch.empty((), dtype=torch.float32, device=flat.device)
    lr_host = np.ascontiguousarray(
        _lr_array(lr, n_iters, "cpu").numpy(), np.float32)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(flat.device):
        rc = lib.fit_run(ptr(flat), ptr(m), ptr(v), ptr(x), ptr(A), ptr(c),
                         ptr(tgt), ptr(w_n),
                         ctypes.c_void_p(lr_host.ctypes.data), ptr(part),
                         ptr(loss), n_iters, K, B, D_in, D_out, H, Lh, T,
                         ctypes.c_void_p(stream))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"fit kernel launch failed: CUDA error {rc}")
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
    """
    if pool_xactw[0].is_cuda:
        return _cuda_adam_fit(params, cfg, pool_xactw, n_iters, lr)
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
