"""The port's key seam (nmcfluid_torch/utils/keys.py) on its own.

Every draw depends on all 64 bits of a key: two keys equal in their low
32 bits draw different streams. A key draws the same numbers every time,
on the CPU, and only then moves them to the requested device. Each draw
has the distribution it names, at fixed sizes and keys, within the
bounds stated in each test. The key tree (split, fold_in, stream_seed)
keeps the values it had before the draws were rewritten. A KeyGroup's
draws are its members' own, stacked, bit for bit: vectorised over Keys,
key by key over any other key class.
"""
import math

import numpy as np
import pytest
import torch
from scipy import stats

from nmcfluid_torch.utils import keys, spans
from nmcfluid_torch.utils.keys import Key, KeyGroup

torch.set_num_threads(1)

LOGITS = torch.log(torch.tensor([0.1, 0.4, 0.2, 0.3]))
DRAWS = {
    "uniform": lambda k, dev="cpu": k.uniform((64,), dev, -1.0, 2.0),
    "normal": lambda k, dev="cpu": k.normal((64,), dev),
    "randint": lambda k, dev="cpu": k.randint((64,), 0, 1000, dev),
    "categorical": lambda k, dev="cpu": k.categorical(LOGITS.to(dev), (64,)),
}
HIGH_ONLY = (0, 1, 12345, (1 << 33) + 7)


@pytest.mark.parametrize("a", HIGH_ONLY)
@pytest.mark.parametrize("kind", sorted(DRAWS))
def test_keys_equal_in_low_32_bits_draw_different_streams(kind, a):
    """Key(a) and Key(a ^ 2^40) differ only above bit 31."""
    draw = DRAWS[kind]
    x, y = draw(Key(a)), draw(Key(a ^ (1 << 40)))
    assert not torch.equal(x, y), (kind, a)


@pytest.mark.parametrize("kind", sorted(DRAWS))
def test_a_key_draws_the_same_numbers_twice(kind):
    draw = DRAWS[kind]
    assert torch.equal(draw(Key(99)), draw(Key(99)))
    assert not torch.equal(draw(Key(99)), draw(Key(100)))


@pytest.mark.parametrize("kind", sorted(DRAWS))
def test_draws_are_made_on_the_cpu_then_moved(kind, monkeypatch):
    """Asked for another device (here "meta"), a draw makes its numbers
    on the CPU, equal to the CPU draw, and moves that tensor: so a run
    draws the same numbers on every device."""
    moved = []
    to = torch.Tensor.to

    def spy(self, *a, **kw):
        if self.device.type == "cpu":
            moved.append(self.clone())
        return to(self, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "to", spy)
    out = DRAWS[kind](Key(5), "meta")
    monkeypatch.undo()
    assert out.device.type == "meta" and out.shape == (64,)
    want = DRAWS[kind](Key(5))
    if kind == "categorical":     # the Gumbel noise moves, then the argmax
        gumbel = moved[-1]
        assert gumbel.shape == (64, 4)
        assert torch.equal(torch.argmax(gumbel + LOGITS, -1), want)
    else:
        assert torch.equal(moved[-1], want)


def test_words_are_splitmix64_of_the_whole_key():
    """The vectorised int64 words equal splitmix64 in Python integers:
    word i is the (i + 1)-th output of splitmix64 seeded with a hash of
    the whole key, at keys with the top bit set too."""
    for value in (0, 7, (1 << 63) + 11, (1 << 64) - 1):
        base = keys._mix64(value ^ keys._DRAW)
        got = keys._words(value, 40).tolist()
        want = [keys._mix64((base + i * keys._GAMMA) & keys._M64)
                for i in range(40)]
        assert [w & keys._M64 for w in got] == want, value


def test_key_tree_is_unchanged():
    """split, fold_in and stream_seed keep the values the port's runs and
    the fast RNG's seeds were drawn with."""
    k = Key(7)
    assert [c.value for c in k.split(3)] == [
        0x9D20C9EBD5DCD11A, 0xF46BC8871956232B, 0x2DC2EA7BB086A71A]
    assert k.fold_in(5).value == 0x8EA5269B74DEE2BC
    assert Key((1 << 63) + 11).fold_in(1 << 40).value == 0xF479E35863C0204C
    assert Key(7).stream_seed() == 7
    assert Key(0xDEADBEEF12345678).stream_seed() == 3432638615


def test_uniform_distribution():
    """200,000 draws in [-2, 3): every one inside; mean and variance
    within 5 standard errors of 0.5 and 25 / 12 (the sample variance's
    standard error for a uniform of width w is w^2 / sqrt(180 n))."""
    n, lo, hi = 200_000, -2.0, 3.0
    u = Key(11).uniform((n,), "cpu", lo, hi)
    assert u.dtype == torch.float32 and u.shape == (n,)
    assert float(u.min()) >= lo and float(u.max()) < hi
    w, x = hi - lo, u.double()
    assert abs(float(x.mean()) - 0.5) < 5 * w / math.sqrt(12 * n)
    assert abs(float(x.var()) - w * w / 12) < 5 * w * w / math.sqrt(180 * n)


def test_normal_distribution():
    """200,000 draws: mean within 5 / sqrt(n) of 0, variance within
    5 sqrt(2 / n) of 1, and the Kolmogorov-Smirnov statistic against
    scipy.stats.norm under its critical value at level 1e-6,
    sqrt(ln(2 / 1e-6) / (2 n))."""
    n = 200_000
    z = Key(12).normal((n,), "cpu")
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
    x = z.double()
    assert abs(float(x.mean())) < 5 / math.sqrt(n)
    assert abs(float(x.var()) - 1.0) < 5 * math.sqrt(2 / n)
    d = stats.kstest(x.numpy(), stats.norm.cdf).statistic
    assert d < math.sqrt(math.log(2 / 1e-6) / (2 * n)), d


def test_randint_distribution():
    """120,000 draws in [-3, 9): no value outside, every value drawn, each
    count within 5 standard deviations of n / 12."""
    n, lo, hi = 120_000, -3, 9
    r = Key(13).randint((n,), lo, hi, "cpu")
    assert r.dtype == torch.int64
    assert int(r.min()) == lo and int(r.max()) == hi - 1
    counts = torch.bincount(r - lo, minlength=hi - lo).double()
    p = 1.0 / (hi - lo)
    assert bool(((counts - n * p).abs()
                 < 5 * math.sqrt(n * p * (1 - p))).all()), counts
    with pytest.raises(ValueError):
        Key(0).randint((4,), 3, 3, "cpu")


@pytest.mark.parametrize("batch", [False, True])
def test_categorical_distribution(batch):
    """100,000 draws from softmax(logits): each index's frequency within
    5 standard errors of its probability; with a (3, 4) batch of logits
    each row draws from its own softmax."""
    n = 100_000
    probs = torch.tensor([[0.1, 0.4, 0.2, 0.3], [0.7, 0.1, 0.1, 0.1],
                          [0.25, 0.25, 0.25, 0.25]], dtype=torch.float64)
    if not batch:
        probs = probs[:1]
    logits = torch.log(probs).float()
    shape = (n, 3) if batch else (n,)
    idx = Key(14).categorical(logits if batch else logits[0], shape)
    assert idx.dtype == torch.int64 and idx.shape == shape
    idx = idx.reshape(n, -1)
    for row in range(probs.shape[0]):
        freq = torch.bincount(idx[:, row], minlength=4).double() / n
        p = probs[row]
        se = torch.sqrt(p * (1 - p) / n)
        assert bool(((freq - p).abs() < 5 * se).all()), (row, freq)


def test_uniform_and_randint_read_the_same_words():
    """Two draws of one key share their words (a key is one stream, as
    in JAX): uniform is the top 24 bits of each word, and randint over
    2^k values its top k bits."""
    k = Key(3)
    u = k.uniform((32,), "cpu")
    r = k.randint((32,), 0, 1 << 24, "cpu")
    np.testing.assert_array_equal(u.numpy() * (1 << 24), r.numpy())


GROUP_DRAWS = {
    "uniform": lambda k: k.uniform((5, 3), "cpu", -2.0, 3.0),
    "randint": lambda k: k.randint((7,), 3, 1000003, "cpu"),
}


class _OtherKey(Key):
    """A key class of the same tree that a KeyGroup does not vectorise."""
    __slots__ = ()
    draws = 0

    def fold_in(self, data):
        return _OtherKey(super().fold_in(data).value)

    def uniform(self, *a, **k):
        _OtherKey.draws += 1
        return super().uniform(*a, **k)

    def randint(self, *a, **k):
        _OtherKey.draws += 1
        return super().randint(*a, **k)


@pytest.mark.parametrize("kind", sorted(GROUP_DRAWS))
def test_group_draws_are_each_keys_own(kind, monkeypatch):
    """A KeyGroup of Keys (the top bit set in some) draws, in one span,
    the per-key draws stacked, bit for bit, and so does its fold_in; a
    group of another key class falls back to drawing key by key and
    gives the same numbers."""
    draw = GROUP_DRAWS[kind]
    values = [0, 7, (1 << 63) + 11, (1 << 64) - 1, 123456789012345]
    members = [Key(v) for v in values]
    want = torch.stack([draw(k) for k in members])
    opened, span = [], keys.span
    monkeypatch.setattr(keys, "span", lambda name: opened.append(name)
                        or span(name))
    sink = {}
    with spans.bound(sink):
        got = draw(KeyGroup(members))
    assert opened == ["key_draw"] and sink["key_draw"] > 0.0
    monkeypatch.undo()
    assert got.dtype == want.dtype and torch.equal(got, want)
    folded = torch.stack([draw(k.fold_in(3)) for k in members])
    assert torch.equal(draw(KeyGroup(members).fold_in(3)), folded)
    _OtherKey.draws = 0
    other = KeyGroup(_OtherKey(v) for v in values)
    assert torch.equal(draw(other), want)
    assert _OtherKey.draws == len(values)
    assert torch.equal(draw(other.fold_in(3)), folded)
