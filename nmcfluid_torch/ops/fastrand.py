"""Counter-based PCG lane RNG, bit-exact with nmcfluid/ops/fastrand.py.

A PCG-style double hash keyed on (seed, step, salt, lane), ~10 integer
ops per draw. torch has little uint32 arithmetic, so every value is held
as a non-negative int64 below 2^32 and masked with 0xFFFFFFFF after each
multiply, xor and shift. Multiplies go through `_mul32`, which splits the
constant into 16-bit halves so no intermediate product exceeds 2^49: a
plain `x * 2654435769` can reach ~2^63.3, past int64's signed range.
"""
import torch

_U32 = 0xFFFFFFFF
_M1 = 747796405
_A1 = 2891336453
_M2 = 277803737
_GOLD = 2654435769       # 2^32 / phi
_C_STEP = 2246822519
_C_SALT = 3266489917


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _U32


def _pcg(x):
    """PCG-XSH output permutation over an LCG state (uint32 -> uint32)."""
    x = (_mul32(x, _M1) + _A1) & _U32
    x = _mul32((x >> ((x >> 28) + 4)) ^ x, _M2)
    return (x >> 22) ^ x


def seed_from_words(w0: int, w1: int) -> int:
    """Collapse the two uint32 words of a JAX key into a stream seed:
    w0 ^ (w1 * GOLD) mod 2^32, as nmcfluid.ops.fastrand.seed_from_key."""
    w1 = int(w1) & _U32
    return (int(w0) & _U32) ^ ((w1 * _GOLD) & _U32)


def uniform(seed, step, salt: int, lanes):
    """U[0,1) float32 per lane. seed: uint32 int, or an int64 tensor of
    them broadcasting against `lanes` (a seed per lane); step: int or
    int64 tensor broadcasting against `lanes`; salt: int; lanes: int64
    tensor."""
    x = _mul32(lanes.to(torch.int64), _GOLD)
    if isinstance(step, torch.Tensor):
        x = x ^ _mul32(step.to(torch.int64) & _U32, _C_STEP)
    else:
        x = x ^ ((int(step) & _U32) * _C_STEP & _U32)
    x = x ^ ((int(salt) & _U32) * _C_SALT & _U32)
    if isinstance(seed, torch.Tensor):
        x = x ^ (seed.to(torch.int64) & _U32)
    else:
        x = x ^ (int(seed) & _U32)
    bits = _pcg(_pcg(x))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
