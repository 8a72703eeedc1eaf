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

`Key` below is the default: each key is a 64-bit integer and children
come from a splitmix64 hash of it. A draw of n numbers reads n 64-bit
words, a counter-based stream over the whole key: word i is the
(i + 1)-th output of splitmix64 seeded with a hash of all 64 bits, so
every bit of a key counts and two keys share a stream only if they are
equal. The words are computed on the CPU in vectorised int64 arithmetic
(wrapping products, masked logical shifts) and the draw is then moved to
the requested device, so a run draws the same numbers on every device
(the draws are small: point batches, pressure clouds, rotations).
uniform takes the top 24 bits of a word, normal the inverse normal CDF of
its top 53 bits in float64, randint the high 64 bits of word x range
(bias under range / 2^64), categorical the Gumbel-max rule over the
uniforms. Each draw is the span "key_draw" (utils/spans.py).
`KeyGroup` draws one stream for each of G keys at once, the (G,) + shape
stack of the members' own draws bit for bit: for members of class Key
the G word streams are computed in cache-sized blocks of rows and moved
in one copy, so a pool build draws a group of batches in one span and
one wait for the device; other key classes (the tests' jax.random
replay) draw key by key.
`stream_seed` folds the key to the fast RNG's 32-bit seed, as
the JAX package folds its key's two words. The numbers differ from
JAX's; a second implementation that replays `jax.random`
(tests/_torch_parity.py) lets the tests hold whole steps against the JAX
package.
"""
import math

import torch

from .spans import span

_M64 = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15
_DRAW = 0x2545F4914F6CDD1D        # separates the draw words from `split`
# words a KeyGroup's draw computes at a time: blocks of whole rows that
# stay in the CPU's cache (one block of a whole group's words would not)
_BLOCK_WORDS = 1 << 16


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective avalanche hash of 64 bits."""
    x = (x + _GAMMA) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _i64(x: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _srl(x, s):
    """Logical right shift of an int64 tensor (a new tensor)."""
    return (x >> s).bitwise_and_((1 << (64 - s)) - 1)


def _words(value: int, n: int):
    """n words of the key `value`: splitmix64 seeded with a hash of the
    whole key, as an int64 tensor on the CPU (the bit patterns of the
    uint64 words)."""
    return _words_each([value], n)[0]


def _words_each(values, n: int):
    """(len(values), n) words, row g those of the key values[g] (as
    `_words`), computed in place after one broadcast add."""
    base = torch.tensor([_i64(_mix64(v ^ _DRAW)) for v in values],
                        dtype=torch.int64)
    x = torch.arange(1, n + 1, dtype=torch.int64).mul_(_i64(_GAMMA))
    x = x + base[:, None]
    x.bitwise_xor_(_srl(x, 30)).mul_(_i64(0xBF58476D1CE4E5B9))
    x.bitwise_xor_(_srl(x, 27)).mul_(_i64(0x94D049BB133111EB))
    return x.bitwise_xor_(_srl(x, 31))


def _unit24(w):
    """float32 uniforms in [0, 1) from words: their top 24 bits."""
    return _srl(w, 40).to(torch.float32).mul_(2.0 ** -24)


def _below(w, lo: int, hi: int):
    """int64 in [lo, hi) from words: floor(w * (hi - lo) / 2^64) + lo,
    from the words' 32-bit halves, in int64."""
    r = int(hi) - int(lo)
    if not 0 < r < 1 << 31:
        raise ValueError(f"randint needs 0 < hi - lo < 2^31, got "
                         f"[{lo}, {hi})")
    v = (_srl(w, 32) * r + _srl((w & 0xFFFFFFFF) * r, 32)) >> 32
    return v + int(lo)


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

    def _uniform01(self, shape):
        """float32 uniforms in [0, 1) on the CPU: a word's top 24 bits."""
        shape = tuple(shape)
        return _unit24(_words(self.value, math.prod(shape))).reshape(shape)

    def uniform(self, shape, device, minval=0.0, maxval=1.0):
        with span("key_draw"):
            u = self._uniform01(shape)
            return (minval + u * (maxval - minval)).to(device)

    def normal(self, shape, device):
        shape = tuple(shape)
        with span("key_draw"):
            w = _words(self.value, math.prod(shape))
            u = (_srl(w, 11).to(torch.float64) + 0.5) * 2.0 ** -53
            return torch.special.ndtri(u).to(torch.float32).reshape(
                shape).to(device)

    def randint(self, shape, lo, hi, device):
        shape = tuple(shape)
        with span("key_draw"):
            w = _words(self.value, math.prod(shape))
            return _below(w, lo, hi).reshape(shape).to(device)

    def categorical(self, logits, shape):
        """Draws from softmax(logits) over its last axis by the Gumbel-max
        rule, as jax.random.categorical: argmax(logits + Gumbel noise)
        with noise of shape `shape` + logits.shape[-1:]."""
        k = logits.shape[-1]
        tiny = torch.finfo(torch.float32).tiny
        with span("key_draw"):
            u = self._uniform01(tuple(shape) + (k,)).clamp_(min=tiny)
            gumbel = (-torch.log(-torch.log(u))).to(logits.device)
            return torch.argmax(gumbel + logits, dim=-1)

    def stream_seed(self) -> int:
        return (self.value ^ (self.value >> 32)) & 0xFFFFFFFF


class KeyGroup:
    """G keys that draw as one: `uniform` and `randint` give the (G,) +
    shape stack of each member's own draw of `shape`, bit for bit, and
    `fold_in` folds every member. Where every member is a Key, the words
    of all G are computed together, in blocks of rows, and the draw is one
    copy to the device and one "key_draw" span; any other key class draws
    key by key."""
    __slots__ = ("keys",)

    def __init__(self, keys):
        self.keys = list(keys)

    def __len__(self):
        return len(self.keys)

    def fold_in(self, data: int):
        return KeyGroup(k.fold_in(data) for k in self.keys)

    def _vectorised(self):
        return all(type(k) is Key for k in self.keys)

    def _draw(self, shape, convert, dtype):
        """(G,) + shape of convert(words) of each member, on the CPU, the
        rows computed a block of about _BLOCK_WORDS words at a time."""
        n = math.prod(shape)
        values = [k.value for k in self.keys]
        out = torch.empty((len(values), n), dtype=dtype)
        rows = max(1, _BLOCK_WORDS // max(1, n))
        for i in range(0, len(values), rows):
            out[i:i + rows] = convert(_words_each(values[i:i + rows], n))
        return out.reshape((len(values),) + shape)

    def uniform(self, shape, device, minval=0.0, maxval=1.0):
        shape = tuple(shape)
        if not self._vectorised():
            return torch.stack([k.uniform(shape, device, minval, maxval)
                                for k in self.keys])
        with span("key_draw"):
            return self._draw(shape, lambda w: minval + _unit24(w) * (
                maxval - minval), torch.float32).to(device)

    def randint(self, shape, lo, hi, device):
        shape = tuple(shape)
        if not self._vectorised():
            return torch.stack([k.randint(shape, lo, hi, device)
                                for k in self.keys])
        with span("key_draw"):
            return self._draw(shape, lambda w: _below(w, lo, hi),
                              torch.int64).to(device)
