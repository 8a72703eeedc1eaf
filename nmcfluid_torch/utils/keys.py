"""The port's one seam for randomness: a small key object.

The JAX package draws every random number from a `jax.random` key tree.
The port walks the same tree call for call — the same `split` counts and
`fold_in` constants at the same places — through objects with this
interface:

    KeyClass.from_seed(seed)           -> key
    key.split(n)                       -> list of n keys
    key.fold_in(data)                  -> key
    key.uniform(shape, device, lo, hi) -> float32 tensor in [lo, hi)
    key.normal(shape, device)          -> float32 tensor, standard normal
    key.randint(shape, lo, hi, device) -> int64 tensor in [lo, hi)
    key.categorical(logits, shape)     -> int64 tensor of indices into the
                                          last axis of `logits`, on its
                                          device
    key.stream_seed()                  -> uint32 seed for ops.fastrand

`Key` below is the default: each key is a 64-bit integer, children come
from a splitmix64 hash, and draws come from a CPU `torch.Generator`
seeded with the key and are then moved to the requested device, so a run
draws the same numbers on every device (the draws are small: point
batches, pressure clouds, rotations). Its numbers differ from JAX's; a
second implementation that replays `jax.random` (tests/_torch_parity.py)
lets the tests hold whole steps against the JAX package.
"""
import torch

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective avalanche hash of 64 bits."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class Key:
    """Integer-valued PRNG key (see the module docstring)."""
    __slots__ = ("value",)

    def __init__(self, seed: int = 0):
        self.value = int(seed) & _M64

    @classmethod
    def from_seed(cls, seed: int):
        return cls(seed)

    def __repr__(self):
        return f"Key({self.value:#x})"

    def split(self, n: int = 2):
        base = _mix64(self.value ^ 0x5851F42D4C957F2D)
        return [Key(_mix64(base + i)) for i in range(n)]

    def fold_in(self, data: int):
        return Key(_mix64(self.value ^ _mix64(int(data) & _M64)))

    def _generator(self):
        g = torch.Generator()
        g.manual_seed(self.value)
        return g

    def uniform(self, shape, device, minval=0.0, maxval=1.0):
        u = torch.rand(tuple(shape), generator=self._generator(),
                       dtype=torch.float32)
        return (minval + u * (maxval - minval)).to(device)

    def normal(self, shape, device):
        return torch.randn(tuple(shape), generator=self._generator(),
                           dtype=torch.float32).to(device)

    def randint(self, shape, lo, hi, device):
        return torch.randint(lo, hi, tuple(shape), generator=self._generator(),
                             dtype=torch.int64).to(device)

    def categorical(self, logits, shape):
        """Draws from softmax(logits) over its last axis by the Gumbel-max
        rule, as jax.random.categorical: argmax(logits + Gumbel noise)
        with noise of shape `shape` + logits.shape[-1:]."""
        k = logits.shape[-1]
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(tuple(shape) + (k,), generator=self._generator(),
                       dtype=torch.float32).clamp_(min=tiny)
        gumbel = -torch.log(-torch.log(u)).to(logits.device)
        return torch.argmax(gumbel + logits, dim=-1)

    def stream_seed(self) -> int:
        return (self.value ^ (self.value >> 32)) & 0xFFFFFFFF
