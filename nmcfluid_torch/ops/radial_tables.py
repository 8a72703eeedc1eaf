"""Inverse-CDF tables for the in-ball radius draw.

`build_table` is the JAX package's float64 numpy/scipy table, copied
(nmcfluid/ops/radial_tables.py:33-57): the quantiles of the scale-free
radial density of t = r/R, one row per log-spaced Z = sqrt(lam)*R, for
the 2D and the 3D screened Green's function; `build_harmonic2d_table`
the one row of the 2D harmonic density 4 t ln(1/t) (:60-70).
`sample_t_screened_u` and `sample_t_harmonic2d_u` are the direct gather
draws. The JAX package
draws on the TPU with a gather-free one-hot matmul form instead; the two
agree to about 1 ulp (radial_tables.py:124-129), and on a GPU a per-lane
gather is a plain load.
"""
import math

import numpy as np
import torch

_N_Z = 128           # log-spaced Z rows
_N_U = 257           # quantile columns
_Z_MIN, _Z_MAX = 1e-3, 4e3
_N_S = 8193          # integration grid per row


def _scaled_g2d(t, Z):
    """e^{z} * 2pi * G_ball2D(r)|_{r=tR} up to positive factors (f64)."""
    import scipy.special as sp
    z = Z * t
    return sp.k0e(z) - sp.i0e(z) * (sp.k0e(Z) / sp.i0e(Z)) * np.exp(
        2.0 * (z - Z))


def _scaled_g3d(t, Z):
    """e^{z} * 4pi R * G_ball3D(r)|_{r=tR} (f64): (1 - e^{z-Z} sinh z /
    sinh Z)/t, with sinh in its e^{-x} sinh x form."""
    z = Z * t
    sh = lambda x: -np.expm1(-2.0 * x) / 2.0   # e^{-x} sinh x
    return (1.0 - (sh(z) / sh(Z)) * np.exp(2.0 * (z - Z))) / np.maximum(
        t, 1e-12)


def build_table(dim: int) -> np.ndarray:
    """(N_Z, N_U) table of t = r/R quantiles for the screened density in
    `dim` = 2 or 3 dimensions."""
    if dim not in (2, 3):
        raise ValueError(f"radial tables: dim {dim} (2 or 3)")
    zs = np.geomspace(_Z_MIN, _Z_MAX, _N_Z)
    us = np.linspace(0.0, 1.0, _N_U)
    s = np.linspace(1e-7, 1.0, _N_S)
    out = np.empty((_N_Z, _N_U))
    for i, Z in enumerate(zs):
        g = _scaled_g2d(s, Z) if dim == 2 else _scaled_g3d(s, Z)
        # radial density ~ s^{dim-1} * G * e^{-z}; e^{-z} = e^{-Z s}
        rho = np.maximum(s ** (dim - 1) * g * np.exp(-Z * s), 0.0)
        cdf = np.concatenate([[0.0], np.cumsum((rho[1:] + rho[:-1])
                                               * np.diff(s) / 2.0)])
        cdf /= cdf[-1]
        cdf = np.maximum.accumulate(cdf)    # strictly increasing for interp
        out[i] = np.interp(us, cdf, s)
    return out


def build_harmonic2d_table() -> np.ndarray:
    """(N_U,) quantiles of the 2D harmonic radial density 4t*ln(1/t)."""
    us = np.linspace(0.0, 1.0, _N_U)
    s = np.linspace(1e-7, 1.0, _N_S)
    rho = np.maximum(-4.0 * s * np.log(s), 0.0)
    cdf = np.concatenate([[0.0], np.cumsum((rho[1:] + rho[:-1])
                                           * np.diff(s) / 2.0)])
    cdf /= cdf[-1]
    cdf = np.maximum.accumulate(cdf)
    return np.interp(us, cdf, s)


_LOG_Z_MIN = math.log(_Z_MIN)
_DLOG = (math.log(_Z_MAX) - _LOG_Z_MIN) / (_N_Z - 1)


def pack_quads(table: np.ndarray) -> np.ndarray:
    """(N_Z, N_U) -> (N_Z-1, N_U-1, 4) bilinear quads [t00, t01, t10, t11]:
    the four neighbours of a draw in one contiguous row."""
    return np.ascontiguousarray(np.stack(
        [table[:-1, :-1], table[:-1, 1:], table[1:, :-1], table[1:, 1:]],
        axis=-1))


def pack_pairs(table: np.ndarray) -> np.ndarray:
    """(N_U,) -> (N_U-1, 2) linear-interpolation pairs [t0, t1]."""
    return np.ascontiguousarray(np.stack([table[:-1], table[1:]], axis=-1))


class QuadTable:
    """pack_quads(build_table(dim)) in float32 (dim 2 or 3), or with dim
    "harmonic2d" pack_pairs(build_harmonic2d_table()), built once on the
    host and copied once to each device that asks for it."""

    def __init__(self, dim):
        self._quads = (pack_pairs(build_harmonic2d_table())
                       if dim == "harmonic2d"
                       else pack_quads(build_table(dim))).astype("float32")
        self._on = {}           # device -> tensor copy of the table

    def on(self, device):
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self._quads).to(device)
            self._on[device] = t
        return t


def sample_t_screened_u(table_quads, Z, u):
    """t = r/R from a uniform u by bilinear inverse-CDF lookup.
    `table_quads`: float32 tensor pack_quads(build_table(dim)) on Z's
    device. Z, u, out: same shape."""
    zi = (torch.log(torch.clamp(Z, _Z_MIN, _Z_MAX)) - _LOG_Z_MIN) / _DLOG
    i0 = torch.clamp(torch.floor(zi).to(torch.int64), 0, _N_Z - 2)
    wi = torch.clamp(zi - i0, 0.0, 1.0)
    uj = u * (_N_U - 1)
    j0 = torch.clamp(torch.floor(uj).to(torch.int64), 0, _N_U - 2)
    wj = uj - j0
    q = table_quads[i0, j0]                          # (..., 4), one gather
    return ((1 - wi) * ((1 - wj) * q[..., 0] + wj * q[..., 1])
            + wi * ((1 - wj) * q[..., 2] + wj * q[..., 3]))


def sample_t_harmonic2d_u(table_pairs, u):
    """t = r/R from a uniform u by linear inverse-CDF lookup in the 2D
    harmonic table. `table_pairs`: float32 tensor
    pack_pairs(build_harmonic2d_table()) on u's device."""
    uj = u * (_N_U - 1)
    j0 = torch.clamp(torch.floor(uj).to(torch.int64), 0, _N_U - 2)
    wj = uj - j0
    p = table_pairs[j0]                              # (..., 2), one gather
    return (1 - wj) * p[..., 0] + wj * p[..., 1]
