"""Free-space Green's kernels of boundary value caching (port of the kernels
of nmcfluid/wost/bvc.py).

The screened-Poisson free-space Green's function G, its radial derivative
and the gradient in x of the Poisson kernel P(x, y; n) = dG/dn_y, in 2D
and 3D, screened (lam > 0) or harmonic. The 2D screened forms use the
exponentially scaled Bessels (ops/bessel.py), so sigma = 350 stays finite
in float32. The BEM projection (sim/bem.py) splats through them.

The JAX module's BvcProjector, which walks the boundary cache with the
lockstep estimator, is not ported.
"""
import math

import torch

from ..ops import bessel


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
