"""Float32-safe scaled modified Bessel functions (port of ops/bessel.py).

i0e/i1e come from torch.special; k0e/k1e are the Abramowitz & Stegun
9.8.5-9.8.8 polynomial fits, ported as written so the port and the JAX
package evaluate the same formula.
"""
import torch
from torch.special import i0e, i1e  # noqa: F401  (re-exported)

_K0_SMALL = (-0.57721566, 0.42278420, 0.23069756, 0.03488590,
             0.00262698, 0.00010750, 0.00000740)
_K0_LARGE = (1.25331414, -0.07832358, 0.02189568, -0.01062446,
             0.00587872, -0.00251540, 0.00053208)
_K1_SMALL = (1.0, 0.15443144, -0.67278579, -0.18156897,
             -0.01919402, -0.00110404, -0.00004686)
_K1_LARGE = (1.25331414, 0.23498619, -0.03655620, 0.01504268,
             -0.00780353, 0.00325614, -0.00068245)


def _poly(coeffs, t):
    acc = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def k0e(x):
    """e^x * K0(x), elementwise, x > 0 (guarded below ~1e-20)."""
    xs = torch.clamp(x, min=1e-20)
    xc = torch.clamp(xs, max=2.0)   # keeps the masked-out branch finite
    t = (xc / 2.0) ** 2
    i0 = i0e(xc) * torch.exp(xc)
    small = torch.exp(xc) * (-torch.log(xc / 2.0) * i0 + _poly(_K0_SMALL, t))
    xl = torch.clamp(xs, min=2.0)
    large = _poly(_K0_LARGE, 2.0 / xl) / torch.sqrt(xl)
    return torch.where(xs <= 2.0, small, large)


def k1e(x):
    """e^x * K1(x), elementwise, x > 0 (guarded below ~1e-20)."""
    xs = torch.clamp(x, min=1e-20)
    xc = torch.clamp(xs, max=2.0)
    t = (xc / 2.0) ** 2
    i1 = i1e(xc) * torch.exp(xc)
    small = torch.exp(xc) * (torch.log(xc / 2.0) * i1
                             + _poly(_K1_SMALL, t) / xc)
    xl = torch.clamp(xs, min=2.0)
    large = _poly(_K1_LARGE, 2.0 / xl) / torch.sqrt(xl)
    return torch.where(xs <= 2.0, small, large)
