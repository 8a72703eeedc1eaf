"""Deterministic boundary-element projection (port of nmcfluid/sim/bem.py):
an FFT volume potential, a Nystrom-solved boundary integral equation and
a kernel splat, for every 2D scene (the box, the channel with its
circles, jpipe's duct).

Per projection, for (Lap - sigma) u = -f with zero-Neumann walls:

  1. The volume potential V_f(x) = int G_sigma(x - y) f(y) dy of the
     domain-masked divergence grid and its gradient, by FFT convolution
     with the free-space Yukawa kernel defined in Fourier space, on the
     (R+1)^2 vertex lattice (so bilinear lookups reach the boundary
     without extrapolating).
  2. The boundary values u_Gamma at an equispaced midpoint cache y_j: the
     interior-limit collocation of u = V_f - int_Gamma P(x, y) u(y) dS_y
     is the dense Nystrom system A u_Gamma = V_f|_Gamma, whose inverse
     depends only on (scene, sigma, resolution): it is built once on the
     host in float64 and cached on disk, and a projection costs one (B, B)
     matvec. The row-sum rule sets the singular diagonal (a constant is
     solved exactly).
  3. The splat u(x) = V_f(x) - sum_j w_j P(x, y_j) (u_j - c(x))
     + c(x) (1 - V_sigma(x)), and the same through grad_x P and grad V
     for the gradient, with c(x) the cache value nearest x (the mean over
     ties) and V_sigma the potential of f == sigma: the shift cancels the
     splat's quadrature error where it is worst, next to the boundary.

`BvcProjector` is the Monte Carlo variant, zombie's boundary value
caching as a projection: the cache values come from a WoSt walk at the
cache points instead of the Nystrom solve (no inverse, no cache file).

The host precompute is float64 numpy/scipy; the device holds the kernel
spectra as complex64, the inverse, the cache and the constant problem's
potentials as float32, and runs FFTs, bilinear gathers, one matvec and
the (E, B) contraction in chunks of at most 2^23 pairs. The open channel
ends are closed with zero-Neumann caps, as the spectral solve closes the
box.
"""
import math
import os
import time

import numpy as np
import torch

from ..geometry.sdf import sqrt_rn
from ..wost.bvc import _free_dGdr, _free_dP

_CACHE_VERSION = 1
# the default home of the cached Nystrom inverses (git-ignored)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "bem_cache")


# ------------------------------------------------------------ host kernels

def _np_G(sigma, r):
    from scipy.special import k0
    return k0(np.sqrt(sigma) * r) / (2.0 * np.pi)


def _np_dGdr(sigma, r):
    from scipy.special import k1
    return -np.sqrt(sigma) * k1(np.sqrt(sigma) * r) / (2.0 * np.pi)


def _np_P(sigma, x, y, n):
    """Poisson kernel P(x, y) = dG/dn_y, pairwise: x (E, 2), y and n (B,
    2)."""
    d = x[:, None, :] - y[None, :, :]
    r = np.sqrt(np.sum(d * d, axis=-1))
    r = np.maximum(r, 1e-300)
    cos = np.sum(d * n[None], axis=-1) / r
    return -_np_dGdr(sigma, r) * cos


# ------------------------------------------------------- boundary sampling

def closed_loops(scene):
    """The scene's closed splat boundary: a list of vertex loops with the
    fluid on the LEFT (normals (d.y, -d.x) point out of the fluid); open
    channel ends are capped."""
    ss = scene.scene_size
    if scene.name == "jpipe":
        # the walls of the jpipe boundary plus inlet and outlet caps: one
        # counter-clockwise loop around the duct
        th = np.linspace(0.0, 0.5 * np.pi, 41)
        outer = ([(0.0, 0.0)]
                 + [(1.0 + np.sin(t), 1.0 - np.cos(t)) for t in th]
                 + [(2.0, 2.0)])
        inner = ([(0.0, 0.5)]
                 + [(1.0 + 0.5 * np.sin(t), 1.0 - 0.5 * np.cos(t))
                    for t in th]
                 + [(1.5, 2.0)])
        return [np.asarray(outer + inner[::-1], np.float64)]
    # any other 2D scene: the box, counter-clockwise (fluid inside)
    xmin, xmax, ymin, ymax = ss[0], ss[1], ss[2], ss[3]
    loops = [np.asarray([(xmin, ymin), (xmax, ymin), (xmax, ymax),
                         (xmin, ymax)], np.float64)]
    circ = []
    if scene.obstacle_center is not None and scene.obstacle_radius:
        circ.append((*scene.obstacle_center, scene.obstacle_radius))
    if scene.obstacles:
        # karman2cyl and karman3cyl: one clockwise loop a circle
        circ.extend(scene.obstacles)
    for cx, cy, r in circ:
        # clockwise (fluid outside); a dense polygon stands in for the
        # circle (geometry error ~ r theta^2 / 2)
        t = -2.0 * np.pi * (np.arange(2048) + 0.5) / 2048
        loops.append(np.stack([cx + r * np.cos(t),
                               cy + r * np.sin(t)], axis=1))
    return loops


def equispaced_boundary(loops, n_total):
    """Midpoint-rule cache: n_total samples equispaced by arclength over
    the loops (allocated in proportion to their lengths). Returns (pts
    (B, 2), outward normals (B, 2), weights (B,), each sample's share of
    arclength)."""
    lens = []
    segs = []
    for loop in loops:
        a = np.asarray(loop, np.float64)
        b = np.roll(a, -1, axis=0)
        ln = np.linalg.norm(b - a, axis=1)
        segs.append((a, b, ln))
        lens.append(ln.sum())
    total = float(np.sum(lens))
    pts, nrms, ws = [], [], []
    for (a, b, ln), L in zip(segs, lens):
        n = max(8, int(round(n_total * L / total)))
        s = (np.arange(n) + 0.5) * (L / n)
        cum = np.concatenate([[0.0], np.cumsum(ln)])
        idx = np.clip(np.searchsorted(cum, s, side="right") - 1,
                      0, len(ln) - 1)
        t = (s - cum[idx]) / np.maximum(ln[idx], 1e-300)
        p = a[idx] + t[:, None] * (b[idx] - a[idx])
        d = b[idx] - a[idx]
        nrm = np.stack([d[:, 1], -d[:, 0]], axis=1)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                          1e-300)
        pts.append(p)
        nrms.append(nrm)
        ws.append(np.full(n, L / n))
    return (np.concatenate(pts), np.concatenate(nrms),
            np.concatenate(ws))


# ------------------------------------------------------- kernel grid (FFT)

def _next_fast(n):
    from scipy.fft import next_fast_len
    return next_fast_len(int(n))


def _kernel_ffts(res, spacing, sigma, r_max):
    """The free-space kernel's spectrum for the vertex-output convolution
    V[v] = int G_sigma(x_v - y) f~(y) dy, f~ the bilinear-hat
    reconstruction of the cell-centered samples: the symbol 1 / (|xi|^2 +
    sigma) times the hat's sinc^2(xi h / 2) per axis, with a half-cell
    phase shift onto the vertices (defined in Fourier space, so the
    symbol's xi^-2 tails do not alias). The padding puts the nearest
    periodic image at least r_max away.

    Returns the complex128 rfft2 arrays (KG, KX, KY) and the pad shape."""
    (Rx, Ry), (hx, hy) = res, spacing
    Nx = _next_fast(Rx + int(np.ceil(r_max / hx)) + 1)
    Ny = _next_fast(Ry + int(np.ceil(r_max / hy)) + 1)
    xi = 2.0 * np.pi * np.fft.fftfreq(Nx, d=hx)[:, None]
    eta = 2.0 * np.pi * np.fft.rfftfreq(Ny, d=hy)[None, :]
    Ghat = 1.0 / (xi ** 2 + eta ** 2 + sigma)
    hat = (np.sinc(xi * hx / (2.0 * np.pi)) ** 2
           * np.sinc(eta * hy / (2.0 * np.pi)) ** 2)
    phase = np.exp(-0.5j * (xi * hx + eta * hy))
    KG = Ghat * hat * phase
    KX = 1j * xi * KG
    KY = 1j * eta * KG
    return KG, KX, KY, (Nx, Ny)


def _vertex_bilerp(grid, scene_size, y):
    """Bilinear gather into an (Rx+1, Ry+1) vertex grid (node i at lo +
    i h); queries in the box never extrapolate."""
    res = grid.shape
    i0s, ws = [], []
    for i in range(2):
        lo, hi = scene_size[2 * i], scene_size[2 * i + 1]
        u = (y[..., i] - lo) / (hi - lo) * (res[i] - 1)
        i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, res[i] - 2)
        i0s.append(i0)
        ws.append(torch.clamp(u - i0.to(u.dtype), 0.0, 1.0))
    flat_grid = grid.reshape(-1)
    out = torch.zeros(y.shape[:-1], dtype=grid.dtype, device=grid.device)
    for corner in range(4):
        flat = torch.zeros(y.shape[:-1], dtype=torch.int64, device=y.device)
        w = torch.ones(y.shape[:-1], dtype=grid.dtype, device=grid.device)
        for i in range(2):
            hi_bit = (corner >> i) & 1
            flat = flat * res[i] + i0s[i] + hi_bit
            w = w * (ws[i] if hi_bit else 1.0 - ws[i])
        out = out + w * flat_grid[flat]
    return out


# --------------------------------------------------------------- projector

class BemProjector:
    """The precomputed projector of one (scene, resolution) on `device`.

    The host precompute is float64; the (B, B) Nystrom inverse, the one
    costly step (B^3), is cached in `cache_dir` (default CACHE_DIR) under
    the port's own file tag and reused only where the file's cache
    points and constant-problem potential match this scene's."""

    def __init__(self, scene, div_resolution, n_boundary=None,
                 eval_chunk=8192, r_max=None, cache_dir=None, device="cpu",
                 nystrom=True):
        if scene.dim != 2:
            raise ValueError("--projection bem is 2D-only (3D scenes are "
                             "box-exact under --projection spectral)")
        if scene.absorption <= 0.0:
            raise ValueError("bem projection needs absorption > 0 "
                             "(truncated Yukawa kernels)")
        from . import sampling
        self.scene = scene
        self.device = torch.device(device)
        self.sigma = float(scene.absorption)
        ss = scene.scene_size
        self.res = sampling.grid_resolutions(ss, div_resolution)
        Rx, Ry = self.res
        hx = (ss[1] - ss[0]) / Rx
        hy = (ss[3] - ss[2]) / Ry
        self.spacing = (hx, hy)
        # kernel truncation: e^{-sqrt(sigma) r_max} ~ 4e-8 at 17/sqrt(sigma)
        r_max = r_max or min(17.0 / math.sqrt(self.sigma),
                             math.hypot(ss[1] - ss[0], ss[3] - ss[2]))
        KGf, KXf, KYf, (Nx, Ny) = _kernel_ffts(
            self.res, self.spacing, self.sigma, r_max)
        self.fft_shape = (Nx, Ny)
        # the fluid indicator at the cell centres masks the source
        centers = np.stack(np.meshgrid(
            ss[0] + (np.arange(Rx) + 0.5) * hx,
            ss[2] + (np.arange(Ry) + 0.5) * hy, indexing="ij"), axis=-1)
        chi = scene.fluid_mask(torch.tensor(
            centers.reshape(-1, 2), dtype=torch.float32)).numpy() \
            .reshape(Rx, Ry).astype(np.float64)
        # the cache's spacing ~ one grid cell by default, capped by the
        # B^3 host factorization
        loops = closed_loops(scene)
        if n_boundary is None:
            perim = sum(
                np.linalg.norm(np.roll(v, -1, 0) - np.asarray(v), axis=1)
                .sum() for v in loops)
            n_boundary = int(min(8192, max(
                256, 2 ** math.ceil(math.log2(perim / min(hx, hy))))))
        pts, nrm, w = equispaced_boundary(loops, n_boundary)
        self.n_boundary = B = len(pts)
        # bound the (C, B) and (C, B, 2) intermediates: C * B <= 2^23
        self.eval_chunk = max(256, min(eval_chunk, (1 << 23) // max(B, 1)))

        # the constant problem f == sigma, by float64 host convolutions:
        # V_sigma and grad V_sigma feed the row-sum diagonal and the
        # constant shift of the splat
        def host_conv(Kf, f):
            return np.fft.irfft2(np.fft.rfft2(f, s=(Nx, Ny)) * Kf,
                                 s=(Nx, Ny))[:Rx + 1, :Ry + 1]

        fc = self.sigma * chi
        Vc = host_conv(KGf, fc)
        gVcx = host_conv(KXf, fc)
        gVcy = host_conv(KYf, fc)

        def host_bilerp(grid, y):
            ux = np.clip((y[:, 0] - ss[0]) / (ss[1] - ss[0]) * Rx, 0, Rx)
            uy = np.clip((y[:, 1] - ss[2]) / (ss[3] - ss[2]) * Ry, 0, Ry)
            i0 = np.clip(np.floor(ux).astype(int), 0, Rx - 1)
            j0 = np.clip(np.floor(uy).astype(int), 0, Ry - 1)
            tx, ty = ux - i0, uy - j0
            return ((1 - tx) * (1 - ty) * grid[i0, j0]
                    + tx * (1 - ty) * grid[i0 + 1, j0]
                    + (1 - tx) * ty * grid[i0, j0 + 1]
                    + tx * ty * grid[i0 + 1, j0 + 1])

        # the BVC subclass walks its cache values and needs no inverse
        A_inv = self._load_or_build_A(scene, pts, nrm, w,
                                      host_bilerp(Vc, pts), div_resolution,
                                      cache_dir) if nystrom else None

        dev = self.device

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        def c64(K):
            return torch.tensor(K.astype(np.complex64), device=dev)

        self.KGf, self.KXf, self.KYf = c64(KGf), c64(KXf), c64(KYf)
        self.chi = f32(chi)
        self.Vc = f32(Vc)
        self.gVc = f32(np.stack([gVcx, gVcy], axis=-1))
        self.cache_pts = f32(pts)
        self.cache_n = f32(nrm)
        self.cache_w = f32(w)
        self.A_inv = f32(A_inv) if A_inv is not None else None

    def _load_or_build_A(self, scene, pts, nrm, w, Vc_cache,
                         div_resolution, cache_dir):
        cache_dir = cache_dir or CACHE_DIR
        tag = (f"torch_{scene.name}_r{div_resolution}_b{len(pts)}"
               f"_s{self.sigma:g}_v{_CACHE_VERSION}")
        path = os.path.join(cache_dir, tag + ".npz")
        if os.path.exists(path):
            with np.load(path) as z:
                if (np.allclose(z["pts"], pts)
                        and np.allclose(z["Vc"], Vc_cache)):
                    return z["A_inv"]
        # u_i + sum_j w_j P_ij u_j = V_f(x_i), the diagonal by the row-sum
        # rule (u == 1 <-> f == sigma): sum_j w_j P_ij == V_sigma(x_i) - 1
        B = len(pts)
        Pij = _np_P(self.sigma, pts, pts, nrm) * w[None, :]
        np.fill_diagonal(Pij, 0.0)
        diag = (Vc_cache - 1.0) - Pij.sum(axis=1)
        A = np.eye(B) + Pij
        A[np.arange(B), np.arange(B)] += diag
        A_inv = np.linalg.inv(A)
        os.makedirs(cache_dir, exist_ok=True)
        # write then rename, so a reader never sees a partial file
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez_compressed(tmp, A_inv=A_inv.astype(np.float32),
                            pts=pts, Vc=Vc_cache)
        os.replace(tmp, path)
        return A_inv

    def solve(self, div_grid, pts):
        """p and grad p at pts (E, 2) for the masked divergence source."""
        return _bem_solve(self, div_grid, pts)


def _volume_potentials(bp, div_grid):
    """The FFT volume potential V_f and its gradient on the vertex
    lattice."""
    Rx, Ry = bp.res
    Nx, Ny = bp.fft_shape
    F = torch.fft.rfft2((div_grid * bp.chi).to(torch.float32), s=(Nx, Ny))
    return tuple(torch.fft.irfft2(F * K, s=(Nx, Ny))[:Rx + 1, :Ry + 1]
                 for K in (bp.KGf, bp.KXf, bp.KYf))


def _bem_solve(bp, div_grid, pts):
    ss = bp.scene.scene_size
    V, Gx, Gy = _volume_potentials(bp, div_grid)
    rhs = _vertex_bilerp(V, ss, bp.cache_pts)
    u_gamma = bp.A_inv @ rhs                                  # (B,)
    return _splat(bp, u_gamma, V, Gx, Gy, pts)


def _splat(bp, u_gamma, V, Gx, Gy, pts):
    """u = V_f + the P-kernel splat of the cache values, with the
    constant-shift correction, and its gradient, at pts (E, 2), in chunks
    of bp.eval_chunk points."""
    ss = bp.scene.scene_size
    sigma = bp.sigma
    us, gs = [], []
    for xc in pts.split(bp.eval_chunk):
        d = xc[:, None, :] - bp.cache_pts[None]               # (C, B, 2)
        r = sqrt_rn(torch.sum(d * d, -1))
        rs = torch.clamp(r, min=1e-9)
        P = -_free_dGdr(2, sigma, rs) * torch.sum(d * bp.cache_n[None], -1) \
            / rs
        dP = _free_dP(2, sigma, d, rs, bp.cache_n[None])      # (C, B, 2)
        # the constant shift: the mean of the cache values at the nearest
        # distance (ties included)
        rmin = torch.min(r, 1, keepdim=True).values
        sel = (r <= rmin).to(torch.float32)
        c = torch.sum(sel * u_gamma[None], 1) \
            / torch.clamp(torch.sum(sel, 1), min=1.0)           # (C,)
        v = (u_gamma[None] - c[:, None]) * bp.cache_w[None]
        u_b = -torch.sum(P * v, 1)
        g_b = -torch.sum(dP * v[..., None], 1)
        u = _vertex_bilerp(V, ss, xc) + u_b \
            + c * (1.0 - _vertex_bilerp(bp.Vc, ss, xc))
        gc = torch.stack([_vertex_bilerp(bp.gVc[..., 0], ss, xc),
                          _vertex_bilerp(bp.gVc[..., 1], ss, xc)], -1)
        g = torch.stack([_vertex_bilerp(Gx, ss, xc),
                         _vertex_bilerp(Gy, ss, xc)], -1) \
            + g_b - c[:, None] * gc
        us.append(u)
        gs.append(g)
    return torch.cat(us), torch.cat(gs)


# ---------------------------------------------------------- MC-cached (BVC)

class BvcProjector(BemProjector):
    """Monte Carlo boundary value caching as a projection (bem.py:462-512):
    WoSt estimates the solution once at the boundary cache, and the splat
    of the BEM path (`_splat`, the same code) carries it to the pressure
    cloud. The du/dn cache term is zero for the fluid's pure-Neumann
    projection, so only the solution is cached; the walk runs at points
    offset 2 epsilon_shell into the fluid (cache_pts - 2 eps cache_n), on
    the executor walk_settings.algo names, with the divergence grid as its
    source."""

    def __init__(self, scene, div_resolution, wost_scene, walk_settings,
                 n_walks=None, n_boundary=None, offset=None, **kw):
        super().__init__(scene, div_resolution, n_boundary=n_boundary,
                         nystrom=False, **kw)
        self.wost_scene = wost_scene
        self.walk_settings = walk_settings
        self.n_walks = n_walks
        off = offset if offset is not None \
            else 2.0 * walk_settings.epsilon_shell
        self.inner_pts = self.cache_pts - off * self.cache_n

    def solve(self, div_grid, pts, key, times=None):
        """p and grad p at pts (E, 2). With a dict `times`, the seconds of
        the cache walk ("bvc_walk", the volume potentials included) and of
        the splat ("bvc_splat") are added to it, by CUDA events on the
        card."""
        from ..wost.solver import estimate_solution_and_gradient
        cuda = times is not None and pts.is_cuda
        if times is not None:
            marks = [_mark(cuda)]
        V, Gx, Gy = _volume_potentials(self, div_grid)
        u_gamma, _, _ = estimate_solution_and_gradient(
            self.wost_scene, self.walk_settings, self.inner_pts, key,
            n_walks=self.n_walks, source_args=(div_grid,))
        if times is not None:
            marks.append(_mark(cuda))
        out = _splat(self, u_gamma, V, Gx, Gy, pts)
        if times is not None:
            marks.append(_mark(cuda))
            for name, a, b in (("bvc_walk", 0, 1), ("bvc_splat", 1, 2)):
                times[name] = times.get(name, 0.0) + _elapsed(marks[a],
                                                              marks[b])
        return out


def _mark(cuda):
    """A time mark: a recorded CUDA event on the card, else the host
    clock."""
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed(a, b):
    """Seconds between two marks of _mark."""
    if isinstance(a, float):
        return b - a
    b.synchronize()
    return a.elapsed_time(b) / 1e3
