"""3D ball Green's functions (harmonic and screened) for walk-on-stars.

Port of nmcfluid/ops/greens3d.py: Harmonic3D, G = (1/r - 1/R)/4pi, and
Yukawa3D. The 3D kernels are elementary
(exp and sinh), kept in their exponentially scaled forms

    sh_e(z)  = e^{-z} sinh z = (1 - e^{-2z})/2
    ch_e(z)  = e^{-z} cosh z = (1 + e^{-2z})/2
    k32e(z)  = 1 + 1/z                      (the K_{3/2}-type term)
    i32e(z)  = ch_e(z) - sh_e(z)/z          (the I_{3/2}-type term)

so nothing overflows in float32 at large sqrt(lam)*R. Every method is
elementwise over a batch of walker lanes; `ball` is a Ball of per-lane
tensors. The in-ball radius is drawn from the 3D inverse-CDF table by
the same one-gather bilinear lookup as in 2D (the JAX package draws with a
gather-free one-hot matmul instead; the two agree to about an ulp).
Draws take their uniforms from the caller: no key reaches this module.
"""
import math
from typing import NamedTuple

import torch

from . import radial_tables as rt

FOUR_PI = 4.0 * math.pi
R_CLAMP = 1e-4  # distributions.h rClamp default


def _sh_e(z):
    return (1.0 - torch.exp(-2.0 * z)) / 2.0


def _ch_e(z):
    return (1.0 + torch.exp(-2.0 * z)) / 2.0


def _k32e(z):
    return 1.0 + 1.0 / z


def _i32e(z):
    return _ch_e(z) - _sh_e(z) / z


class Ball(NamedTuple):
    """Per-lane ball parameters."""
    R: torch.Tensor
    Z: torch.Tensor        # sqrt(lam) * R
    sh_e_R: torch.Tensor
    k32e_R: torch.Tensor
    i32e_R: torch.Tensor


class Harmonic3D:
    """G(r) = (1/r - 1/R)/4pi on a ball (distributions.h:477-561). Static
    methods, as the JAX class."""
    dim = 3
    screened = False

    @staticmethod
    def make_ball(R):
        z = torch.zeros_like(R)
        return Ball(R=R, Z=z, sh_e_R=z, k32e_R=z, i32e_R=z)

    @staticmethod
    def eval(ball, r):
        return (1.0 / r - 1.0 / ball.R) / FOUR_PI

    @staticmethod
    def norm(ball):
        return ball.R * ball.R / 6.0

    @staticmethod
    def dspk(ball, r):
        return torch.ones_like(r)

    @staticmethod
    def pk_over_uniform(ball):
        return torch.ones_like(ball.R)

    @staticmethod
    def pk_grad_coeff(ball):
        # poissonKernelGradient = 3 d / (4pi R^2), d = ySurf - c
        return 3.0 / (FOUR_PI * ball.R * ball.R)

    @staticmethod
    def grad_norm(ball, r):
        return (1.0 / (r * r * r) - 1.0 / (ball.R ** 3)) / FOUR_PI

    @staticmethod
    def pk_grad_over_thr(ball):
        return 3.0 / (FOUR_PI * ball.R * ball.R)

    @staticmethod
    def grad_norm_over_eval(ball, r):
        r = torch.minimum(torch.clamp(r, min=R_CLAMP), 0.999 * ball.R)
        num = 1.0 / (r ** 3) - 1.0 / (ball.R ** 3)
        den = torch.clamp(1.0 / r - 1.0 / ball.R, min=1e-12)
        return num / den

    @staticmethod
    def radial_pdf(ball, r):
        # [eval/norm] * 4 pi r^2 = 6 r (R - r) / R^3
        return 6.0 * r * (ball.R - r) / (ball.R ** 3)

    @staticmethod
    def sample_radius_u(ball, u2):
        """Ulrich's polar method in closed form (distributions.h:483-496)
        from caller-supplied uniforms (..., 2). Returns (r, G(r))."""
        phi = 2.0 * math.pi * u2[..., 1]
        r = (1.0 + torch.sqrt(torch.clamp(
            1.0 - torch.pow(u2[..., 0] ** 2, 1.0 / 3.0), min=0.0))
            * torch.cos(phi)) * ball.R / 2.0
        r = torch.clamp(r, min=R_CLAMP)
        r = torch.where(r > ball.R, ball.R / 2.0, r)
        return r, Harmonic3D.eval(ball, r)


class Yukawa3D:
    """Screened G on a ball: (e^{-z} - e^{-Z} sinh z / sinh Z)/(4 pi r),
    z = sqrt(lam) r."""
    dim = 3
    screened = True

    def __init__(self, lam):
        self.lam = float(lam)
        self.sqrt_lam = math.sqrt(float(lam))
        self._table = rt.QuadTable(3)

    def make_ball(self, R):
        Z = self.sqrt_lam * R
        return Ball(R=R, Z=Z, sh_e_R=_sh_e(Z), k32e_R=_k32e(Z),
                    i32e_R=_i32e(Z))

    def _cross(self, ball, z):
        # exp(2z - 2Z) factor carried by the cross terms; z <= Z
        return torch.exp(2.0 * (z - ball.Z))

    def eval(self, ball, r):
        z = self.sqrt_lam * r
        q = 1.0 - (_sh_e(z) / ball.sh_e_R) * self._cross(ball, z)
        return torch.exp(-z) * q / (FOUR_PI * r)

    def norm(self, ball):
        # (1 - 4pi*poissonKernel)/lam, poissonKernel = Z/(4pi sinh Z)
        return (1.0 - ball.Z * torch.exp(-ball.Z) / ball.sh_e_R) / self.lam

    def dspk(self, ball, r):
        # per-step throughput multiplier
        r = torch.clamp(r, min=R_CLAMP)
        z = self.sqrt_lam * r
        q = _k32e(z) + _i32e(z) * self._cross(ball, z) / ball.sh_e_R
        return z * torch.exp(-z) * q

    def pk_over_uniform(self, ball):
        # (Z/(4pi sinh Z)) / (1/4pi)
        return ball.Z * torch.exp(-ball.Z) / ball.sh_e_R

    def pk_grad_coeff(self, ball):
        # poissonKernelGradient = d * lam/(4pi I32(Z))
        return self.lam * torch.exp(-ball.Z) / (FOUR_PI * ball.i32e_R)

    def grad_norm(self, ball, r):
        z = self.sqrt_lam * r
        q = _k32e(z) - _i32e(z) * (ball.k32e_R / ball.i32e_R) \
            * self._cross(ball, z)
        return self.sqrt_lam * torch.exp(-z) * q / (FOUR_PI * r * r)

    def pk_grad_over_thr(self, ball):
        """poissonKernelGradient coeff / directionSampledPoissonKernel with
        the e^{-Z} factors cancelled: sqrt(lam) sh_e(Z)/(4pi R i32e(Z))."""
        return self.sqrt_lam * ball.sh_e_R / (FOUR_PI * ball.R
                                              * ball.i32e_R)

    def grad_norm_over_eval(self, ball, r):
        """sqrt(lam) q1/(r q0) with the shared e^{-z} cancelled; r is
        clipped just inside the ball, where q0 and q1 vanish together."""
        r = torch.minimum(torch.clamp(r, min=R_CLAMP), 0.999 * ball.R)
        z = self.sqrt_lam * r
        c = self._cross(ball, z)
        q0 = 1.0 - (_sh_e(z) / ball.sh_e_R) * c
        q1 = _k32e(z) - _i32e(z) * (ball.k32e_R / ball.i32e_R) * c
        return self.sqrt_lam * q1 / (r * torch.clamp(q0, min=1e-10))

    def radial_pdf(self, ball, r):
        return self.eval(ball, r) * FOUR_PI * r * r / self.norm(ball)

    def rejection_bound(self, ball):
        # distributions.h:721-723
        R, lam, slam = ball.R, self.lam, self.sqrt_lam
        sR = torch.sqrt(R)
        small = R <= lam
        lo = torch.where(small, torch.clamp(2.0 / R, min=2.0 / lam),
                         torch.clamp(2.0 / R, max=2.0 / lam))
        hi = torch.where(small, torch.clamp(0.5 * sR, min=0.5 * slam),
                         torch.clamp(0.5 * sR, max=0.5 * slam))
        return torch.maximum(lo, hi)

    def sample_radius_u(self, ball, u2):
        """In-ball radius from caller-supplied uniforms (..., 2) by the
        inverse-CDF table (only u2[..., 0] is used). Returns (r, G(r))."""
        t = rt.sample_t_screened_u(self._table.on(ball.Z.device), ball.Z,
                                   u2[..., 0])
        r = torch.minimum(torch.clamp(t * ball.R, min=R_CLAMP), ball.R)
        return r, self.eval(ball, r)
