"""2D ball Green's functions (harmonic and screened) for walk-on-stars.

Port of nmcfluid/ops/greens2d.py: Harmonic2D, G = log(R/r)/2pi, and
Yukawa2D in the same scaled-Bessel form (z = sqrt(lam) r, Z = sqrt(lam)
R; ratios like K0(Z)/I0(Z) as (k0e/i0e) e^{-2Z}, cross terms carrying
e^{2z-2Z} <= 1), so every quantity stays finite in float32. Every method
is elementwise over a batch of walker lanes; `ball` is a Ball of per-lane
tensors. Draws take their uniforms from the caller: no key reaches this
module.
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


_H2D_TABLE = rt.QuadTable("harmonic2d")


class Harmonic2D:
    """G(r) = log(R/r)/2pi on a ball of radius R (distributions.h:397-474).
    Static methods, as the JAX class: there is no sigma to hold."""
    dim = 2
    screened = False

    @staticmethod
    def make_ball(R):
        z = torch.zeros_like(R)
        return Ball(R=R, Z=z, i0e_R=z, i1e_R=z, k0e_R=z, k1e_R=z)

    @staticmethod
    def eval(ball, r):
        return torch.log(ball.R / r) / TWO_PI

    @staticmethod
    def norm(ball):
        return ball.R * ball.R / 4.0

    @staticmethod
    def dspk(ball, r):
        # directionSampledPoissonKernel == 1: throughput is preserved
        return torch.ones_like(r)

    @staticmethod
    def pk_over_uniform(ball):
        # poissonKernel()/pdfSampleSphereUniform(1) == 1
        return torch.ones_like(ball.R)

    @staticmethod
    def pk_grad_coeff(ball):
        # poissonKernelGradient = coeff * (ySurf - c);  2d/(2pi R^2)
        return 2.0 / (TWO_PI * ball.R * ball.R)

    @staticmethod
    def grad_norm(ball, r):
        return (1.0 / (r * r) - 1.0 / (ball.R * ball.R)) / TWO_PI

    @staticmethod
    def pk_grad_over_thr(ball):
        """poissonKernelGradient coeff / directionSampledPoissonKernel."""
        return 2.0 / (TWO_PI * ball.R * ball.R)

    @staticmethod
    def grad_norm_over_eval(ball, r):
        """gradient(r)/evaluate(r), r clipped just inside the ball."""
        r = torch.minimum(torch.clamp(r, min=R_CLAMP), 0.999 * ball.R)
        num = 1.0 / (r * r) - 1.0 / (ball.R * ball.R)
        den = torch.clamp(torch.log(ball.R / r), min=1e-12)
        return num / den

    @staticmethod
    def radial_pdf(ball, r):
        # [eval/norm] * 2 pi r, the marginal over the angle
        return 4.0 * r * torch.log(ball.R / r) / (ball.R * ball.R)

    @staticmethod
    def rejection_bound(ball):
        return 1.5 / ball.R

    @staticmethod
    def sample_radius_u(ball, u2):
        """In-ball radius from caller-supplied uniforms (..., 2) by the
        harmonic inverse-CDF table (only u2[..., 0] is used)."""
        t = rt.sample_t_harmonic2d_u(_H2D_TABLE.on(ball.R.device),
                                     u2[..., 0])
        r = torch.minimum(torch.clamp(t * ball.R, min=R_CLAMP), ball.R)
        return r, Harmonic2D.eval(ball, r)


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

    def pk_grad_coeff(self, ball):
        # poissonKernelGradient = d * sqrt(lam)/(2pi R I1(Z))
        return self.sqrt_lam * torch.exp(-ball.Z) / (TWO_PI * ball.R
                                                     * ball.i1e_R)

    def grad_norm(self, ball, r):
        z = self.sqrt_lam * r
        q = k1e(z) - i1e(z) * (ball.k1e_R / ball.i1e_R) * self._cross(ball, z)
        return self.sqrt_lam * torch.exp(-z) * q / (TWO_PI * r)

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

    def radial_pdf(self, ball, r):
        return self.eval(ball, r) * TWO_PI * r / self.norm(ball)

    def rejection_bound(self, ball):
        # distributions.h:594-596 empirical envelope of the radial pdf
        R, lam, slam = ball.R, self.lam, self.sqrt_lam
        sR = torch.sqrt(R)
        small = R <= lam
        lo = torch.where(small, torch.clamp(2.2 / R, min=2.2 / lam),
                         torch.clamp(2.2 / R, max=2.2 / lam))
        hi = torch.where(small, torch.clamp(0.6 * sR, min=0.6 * slam),
                         torch.clamp(0.6 * sR, max=0.6 * slam))
        return torch.maximum(lo, hi)

    def sample_radius_u(self, ball, u2):
        """In-ball radius from caller-supplied uniforms (..., 2) by the
        inverse-CDF table (only u2[..., 0] is used). Returns (r, G(r))."""
        t = rt.sample_t_screened_u(self._table.on(ball.Z.device), ball.Z,
                                   u2[..., 0])
        r = torch.minimum(torch.clamp(t * ball.R, min=R_CLAMP), ball.R)
        return r, self.eval(ball, r)


def sample_radius_rejection(greens, ball, u):
    """The in-ball radius from the Green's function's radial density by
    rejection, as GreensFnBall::rejectionSampleGreensFn
    (distributions.h:362-383): a uniform proposal on (0, R), accepted with
    probability radial_pdf / bound; the last round's proposal is kept when
    none accepts. `u` is (2, rounds) + R.shape caller-supplied uniforms:
    u[0] the acceptance draws, u[1] the proposals. Returns (r, G(r))."""
    R = ball.R
    rounds = u.shape[1]
    bound = greens.rejection_bound(ball)
    rs = torch.clamp(u[1] * R[None], min=R_CLAMP)
    pdf_r = greens.radial_pdf(type(ball)(*(a[None] for a in ball)), rs)
    acc = u[0] < pdf_r / bound[None]
    first = torch.argmax(acc.to(torch.int32), dim=0)
    idx = torch.where(torch.any(acc, dim=0), first,
                      torch.full_like(first, rounds - 1))
    r = torch.gather(rs, 0, idx[None])[0]
    r = torch.where(r > R, R / 2.0, torch.clamp(r, min=R_CLAMP))
    return r, greens.eval(ball, r)
