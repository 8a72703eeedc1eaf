"""Boundary value caching (port of nmcfluid/wost/bvc.py): zombie's
secondary estimator (boundary_value_caching/{boundary_sampler,
splatter}.h). WoSt estimates the solution u (and, on a Dirichlet
boundary, du/dn) once at a cache of boundary samples, and evaluation
anywhere splats the cache through the free-space Green's function G and
Poisson kernel P:

    u(x) = sum_b alpha [G(x,y_b) du/dn(y_b) - P(x,y_b) u(y_b)] / (B pdf_b)
         + sum_s alpha  G(x,y_s) f(y_s) / (S pdf_s)

and the gradient through grad_x G and grad_x P (splatter.h:208-305),
with alpha = 2 for evaluation points on the boundary (whose gradient
splat is zeroed). The free-space kernels come in 2D and 3D, screened
(lam > 0) or harmonic; the 2D screened forms use the exponentially
scaled Bessels (ops/bessel.py), so sigma = 350 stays finite in float32.
The BEM and BVC projections (sim/bem.py) splat through them.
"""
import math
from typing import NamedTuple, Optional

import torch

from ..ops import bessel
from .solver import (WalkSettings, WostScene, estimate_solution,
                     estimate_solution_and_gradient)


def _free_G(dim, lam, r):
    if dim == 2:
        if lam > 0.0:
            z = math.sqrt(lam) * r
            return bessel.k0e(z) * torch.exp(-z) / (2.0 * math.pi)
        return -torch.log(r) / (2.0 * math.pi)
    if lam > 0.0:
        z = math.sqrt(lam) * r
        return torch.exp(-z) / (4.0 * math.pi * r)
    return 1.0 / (4.0 * math.pi * r)


def _free_dGdr(dim, lam, r):
    if dim == 2:
        if lam > 0.0:
            s = math.sqrt(lam)
            z = s * r
            return -s * bessel.k1e(z) * torch.exp(-z) / (2.0 * math.pi)
        return -1.0 / (2.0 * math.pi * r)
    if lam > 0.0:
        z = math.sqrt(lam) * r
        return -torch.exp(-z) * (1.0 + z) / (4.0 * math.pi * r ** 2)
    return -1.0 / (4.0 * math.pi * r ** 2)


def _free_dP(dim, lam, d, r, n):
    """grad_x P(x, y; n) with d = x - y: (..., dim)."""
    r = torch.clamp(r, min=1e-12)[..., None]
    ndotd = torch.sum(n * d, -1, keepdim=True)
    if dim == 2:
        if lam > 0.0:
            s = math.sqrt(lam)
            z = s * r
            e = torch.exp(-z)
            K0, K1 = bessel.k0e(z) * e, bessel.k1e(z) * e
            Qr1 = s * K1
            # (K0 + K2)/2 = K0 + K1/z  (K2 = K0 + 2 K1/z)
            Qr2 = lam * (K0 + K1 / torch.clamp(z, min=1e-12))
            return (n * Qr1 - (ndotd / r ** 2) * (Qr1 + r * Qr2) * d) \
                / (2.0 * math.pi * r)
        return (n - 2.0 * (ndotd / r ** 2) * d) / (2.0 * math.pi * r ** 2)
    if lam > 0.0:
        s = math.sqrt(lam)
        z = s * r
        e = torch.exp(-z)
        Qr1 = s * e * (1.0 + 1.0 / torch.clamp(z, min=1e-12))
        Qr2 = e * (z * z + z + 1.0) / r
        return (n * Qr1 - (ndotd / r ** 2) * (2.0 * Qr1 + Qr2) * d) \
            / (4.0 * math.pi * r ** 2)
    return (n - 3.0 * (ndotd / r ** 2) * d) / (4.0 * math.pi * r ** 3)


def _regularize_P(dim, r_hat):
    """splatter.h:30-41."""
    if dim == 2:
        return 1.0 - torch.exp(-r_hat ** 2)
    return torch.special.erf(r_hat) \
        - 2.0 * r_hat * torch.exp(-r_hat ** 2) / math.sqrt(math.pi)


def _regularize_G(dim, r_hat):
    """splatter.h:12-27."""
    if dim == 2:
        return torch.ones_like(r_hat)
    return torch.special.erf(r_hat)


# -------------------------------------------------------- boundary sampling

class BoundaryCache(NamedTuple):
    pts: torch.Tensor        # (B, D) cache positions (on the boundary)
    normals: torch.Tensor    # (B, D) outward (out-of-fluid) normals
    pdf: torch.Tensor        # (B,) sampling density w.r.t. boundary measure
    solution: torch.Tensor   # (B,) WoSt estimates of u at the cache
    normal_derivative: torch.Tensor  # (B,) du/dn: the Neumann data on a
    # Neumann boundary (boundary_sampler.h:190-196), WoSt-estimated on a
    # Dirichlet one (:213-216)


def sample_boundary_uniform(soup, n, key):
    """Uniform-by-length boundary samples on a Seg2D soup -> (pts, normals,
    pdf) (boundary_sampler.h's uniform sampling). The segment is a
    categorical draw from `key`'s first split, the place on it a uniform
    from the second."""
    a, b, nrm = soup.a, soup.b, soup.n
    ln = torch.linalg.vector_norm(b - a, dim=-1)
    ln = torch.where(ln < 1.0, ln, 0.0)       # padded slots are FAR apart
    total = torch.sum(ln)
    k1, k2 = key.split(2)
    idx = k1.categorical(torch.log(torch.clamp(ln, min=1e-30)), (n,))
    u = k2.uniform((n, 1), a.device)
    pts = a[idx] + u * (b[idx] - a[idx])
    pdf = torch.full((n,), 1.0, dtype=torch.float32, device=a.device) / total
    return pts, nrm[idx], pdf


def build_cache(scene: WostScene, settings: WalkSettings, soup, n_cache,
                key, n_walks=None, offset=None, dirichlet: bool = False,
                n_walks_grad: Optional[int] = None):
    """WoSt estimates of the boundary data at cache samples offset one
    epsilon shell pair into the fluid (offset 2 epsilon_shell by default).
    A Neumann cache (dirichlet=False) walks the solution only and takes
    du/dn from the Neumann data (boundary_sampler.h:171-175, 190-196); a
    Dirichlet cache walks solution and gradient and caches grad . n
    (:154-167, 213-216)."""
    k1, k2 = key.split(2)
    pts, normals, pdf = sample_boundary_uniform(soup, n_cache, k1)
    off = offset if offset is not None else 2.0 * settings.epsilon_shell
    inner = pts - off * normals
    if dirichlet:
        sol, grad, _ = estimate_solution_and_gradient(
            scene, settings, inner, k2, n_walks_grad or n_walks,
            mask_invalid=False)
        dn = torch.sum(grad * normals, -1)
    else:
        sol, _, _ = estimate_solution(scene, settings, inner, k2, n_walks)
        dn = (scene.neumann_fn(pts) if scene.neumann_fn is not None
              else torch.zeros_like(sol))
    return BoundaryCache(pts=pts, normals=normals, pdf=pdf, solution=sol,
                         normal_derivative=dn)


# --------------------------------------------------------------- evaluation

def evaluate(scene: WostScene, cache: BoundaryCache, eval_pts, src_pts,
             src_pdf, n_src_total: int, radius_clamp: float = 0.0,
             kernel_regularization: float = 0.0,
             with_gradient: bool = False, on_boundary=None, source_args=()):
    """Splat the cache (and a Monte Carlo source sum over src_pts with
    density src_pdf, unless src_pts is None) to eval_pts: u, or (u, grad
    u (E, D)) with_gradient. `on_boundary` (E,) bool marks evaluation
    points on the boundary: alpha = 2 for their value, a zero gradient
    (splatter.h:238-245)."""
    dim = scene.dim
    lam = float(scene.absorption)
    B = cache.pts.shape[0]
    alpha = torch.where(on_boundary, 2.0, 1.0) if on_boundary is not None \
        else 1.0

    d = eval_pts[:, None, :] - cache.pts[None, :, :]      # (E, B, D)
    r = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=radius_clamp)
    r_safe = torch.clamp(r, min=1e-12)
    G = _free_G(dim, lam, r_safe)
    dGdr = _free_dGdr(dim, lam, r_safe)
    cosang = torch.sum(d * cache.normals[None], -1) / r_safe
    # P(x, y) = dG/dr * ((y - x) . n)/r = -dGdr * cos
    P = -dGdr * cosang
    if kernel_regularization > 0.0:
        P = P * _regularize_P(dim, r / kernel_regularization)
        G = G * _regularize_G(dim, r / kernel_regularization)
    w = 1.0 / (cache.pdf[None] * B)
    h = cache.normal_derivative[None]
    u_b = torch.sum((G * h - P * cache.solution[None]) * w, 1)
    if on_boundary is not None:
        u_b = alpha * u_b

    if with_gradient:
        # as in the reference, only the value kernels are regularized
        # (splatter.h:232-247)
        dG = (dGdr / r_safe)[..., None] * d               # grad_x G
        dP = _free_dP(dim, lam, d, r, cache.normals[None])
        g_b = torch.sum((dG * h[..., None]
                         - dP * cache.solution[None, :, None])
                        * w[..., None], 1)
        if on_boundary is not None:
            g_b = torch.where(on_boundary[:, None], 0.0, g_b)

    u_s = g_s = 0.0
    if src_pts is not None:
        ds_vec = eval_pts[:, None, :] - src_pts[None]
        ds = torch.clamp(torch.clamp(torch.linalg.vector_norm(ds_vec, dim=-1),
                                     min=radius_clamp), min=1e-12)
        Gs = _free_G(dim, lam, ds)
        if kernel_regularization > 0.0:
            Gs = Gs * _regularize_G(dim, ds / kernel_regularization)
        f = scene.source_fn(src_pts, *source_args)
        ws = 1.0 / (src_pdf[None] * n_src_total)
        u_s = torch.sum(Gs * f[None] * ws, 1)
        if on_boundary is not None:
            u_s = alpha * u_s
        if with_gradient:
            dGs = (_free_dGdr(dim, lam, ds) / ds)[..., None] * ds_vec
            g_s = torch.sum(dGs * (f[None] * ws)[..., None], 1)
            if on_boundary is not None:
                g_s = torch.where(on_boundary[:, None], 0.0, g_s)

    if with_gradient:
        return u_b + u_s, g_b + g_s
    return u_b + u_s
