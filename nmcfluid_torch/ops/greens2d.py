"""2D screened (Yukawa) ball Green's function for walk-on-stars.

Port of nmcfluid/ops/greens2d.py::Yukawa2D in the same scaled-Bessel form
(z = sqrt(lam) r, Z = sqrt(lam) R; ratios like K0(Z)/I0(Z) as
(k0e/i0e) e^{-2Z}, cross terms carrying e^{2z-2Z} <= 1), so every
quantity stays finite in float32. Every method is elementwise over a batch
of walker lanes; `ball` is a Ball of per-lane tensors.

Only the screened function is ported: the fluid runs sigma = 350 from the
first step (steps_before_tikhonov = 0), so the harmonic one is not on the
path.
"""
import math
from typing import NamedTuple

import torch

from . import radial_tables as rt
from .bessel import i0e, i1e, k0e, k1e

TWO_PI = 2.0 * math.pi
R_CLAMP = 1e-4  # distributions.h rClamp default


class Ball(NamedTuple):
    """Per-lane ball parameters."""
    R: torch.Tensor
    Z: torch.Tensor        # sqrt(lam) * R
    i0e_R: torch.Tensor
    i1e_R: torch.Tensor
    k0e_R: torch.Tensor
    k1e_R: torch.Tensor


class Yukawa2D:
    """Screened G on a ball: (K0(z) - I0(z)K0(Z)/I0(Z))/2pi, z=sqrt(lam)r."""
    dim = 2
    screened = True

    def __init__(self, lam):
        self.lam = float(lam)
        self.sqrt_lam = math.sqrt(float(lam))
        self._table = rt.QuadTable(2)

    def make_ball(self, R):
        Z = self.sqrt_lam * R
        return Ball(R=R, Z=Z, i0e_R=i0e(Z), i1e_R=i1e(Z),
                    k0e_R=k0e(Z), k1e_R=k1e(Z))

    def _cross(self, ball, z):
        # exp(2z - 2Z) factor carried by I(z)*K(Z)/I(Z) cross terms; z<=Z
        return torch.exp(2.0 * (z - ball.Z))

    def eval(self, ball, r):
        z = self.sqrt_lam * r
        q = k0e(z) - i0e(z) * (ball.k0e_R / ball.i0e_R) * self._cross(ball, z)
        return torch.exp(-z) * q / TWO_PI

    def norm(self, ball):
        # (1 - 2pi*poissonKernel)/lam, poissonKernel = 1/(2pi I0(Z))
        return (1.0 - torch.exp(-ball.Z) / ball.i0e_R) / self.lam

    def dspk(self, ball, r):
        # z*(K1(z) + I1(z)K0(Z)/I0(Z)) — per-step throughput multiplier
        r = torch.clamp(r, min=R_CLAMP)
        z = self.sqrt_lam * r
        q = k1e(z) + i1e(z) * (ball.k0e_R / ball.i0e_R) * self._cross(ball, z)
        return z * torch.exp(-z) * q

    def pk_over_uniform(self, ball):
        # (1/(2pi I0(Z))) / (1/2pi) = 1/I0(Z)
        return torch.exp(-ball.Z) / ball.i0e_R

    def pk_grad_over_thr(self, ball):
        """poissonKernelGradient coeff / directionSampledPoissonKernel with
        the e^{-Z} factors cancelled: sqrt(lam) i0e(Z)/(2pi R i1e(Z))."""
        return self.sqrt_lam * ball.i0e_R / (TWO_PI * ball.R * ball.i1e_R)

    def grad_norm_over_eval(self, ball, r):
        """sqrt(lam) q1/(r q0) with the shared e^{-z} cancelled;
        q0, q1 -> 0 together as r -> R, so r is clipped just inside."""
        r = torch.minimum(torch.clamp(r, min=R_CLAMP), 0.999 * ball.R)
        z = self.sqrt_lam * r
        c = self._cross(ball, z)
        q0 = k0e(z) - i0e(z) * (ball.k0e_R / ball.i0e_R) * c
        q1 = k1e(z) - i1e(z) * (ball.k1e_R / ball.i1e_R) * c
        return self.sqrt_lam * q1 / (r * torch.clamp(q0, min=1e-10))

    def sample_radius_u(self, ball, u2):
        """In-ball radius from caller-supplied uniforms (..., 2) by the
        inverse-CDF table (only u2[..., 0] is used). Returns (r, G(r))."""
        t = rt.sample_t_screened_u(self._table.on(ball.Z.device), ball.Z,
                                   u2[..., 0])
        r = torch.minimum(torch.clamp(t * ball.R, min=R_CLAMP), ball.R)
        return r, self.eval(ball, r)
