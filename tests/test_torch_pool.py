"""The fused fit's pool built in grouped passes (nmcfluid_torch/sim/fluid.py
`_build_pool`) against the per-batch loop, on the CPU at small sizes.

The loop is the pool as one batch at a time builds it: `batch(key.fold_in(i))`
and the hard-BC affine map of its points, stacked. The grouped build takes G
batches a pass, with a partial last group (K = 5, G = 2): its points and
weights equal the loop's bit for bit, its affine maps and targets within
1e-6 of their scale. The cases cover Taylor-Green, smoke's jet jitter
broadcast over a group, karman's obstacle rejection rounds, jpipe's pipe
mask on a soup scene, the MacCormack advection target, the projection
phase's cloud draws and the grid sample patterns. The group size follows the shapes: a pass holds at most
_POOL_POINTS points, and fewer where the boundary is a soup. Smoke's grouped
hard BCs draw their jitter once, at the shape of one batch.
"""
import dataclasses

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
from nmcfluid_torch.geometry.sdf import dist_to
from nmcfluid_torch.models.boundary import JET_CENTER, apply_boundary
from nmcfluid_torch.scenes import get_scene
from nmcfluid_torch.sim import fluid as F
from nmcfluid_torch.sim import sampling
from nmcfluid_torch.utils import keys, spans
from nmcfluid_torch.utils.keys import Key

K, G = 5, 2
KEY = Key(0xC0FFEE123456789)


def _fluid(scene, res, pattern="random"):
    spec = dataclasses.replace(get_scene(scene), sample_pattern=pattern)
    return F.NeuralFluid(spec, device="cpu",
                         projection="bem" if scene == "jpipe" else "spectral",
                         sample_resolution=res, fit_pool=K, max_n_iters=4)


def _loop_pool(f, key, bf):
    rows = []
    for i in range(f.fit_pool):
        x, target, w = bf.batch(key.fold_in(i))
        A, c = bf.affine(x)
        rows.append((x, A, c, target, w))
    return tuple(torch.stack(a) for a in zip(*rows))


def _batches(f, phase, flag):
    s0, s1 = f.init_state(1), f.init_state(2)
    if phase == "advect":
        return F._AdvectBatches(f, flag, s0.params, s1.params, f.scene.dt,
                                s0.eps, 3)
    gen = torch.Generator().manual_seed(4)
    n, d = 1000, f.scene.dim
    lo, hi = f._bbox_lo, f._bbox_hi
    cloud = lo + torch.rand(n, d, generator=gen) * (hi - lo)
    return F._ProjectBatches(f, s0.params, cloud,
                             torch.randn(n, d, generator=gen), s0.eps, 3)


def _exercised(f, scene, pool):
    """The case reaches what it is there for."""
    x, w = pool[0], pool[4]
    n = f.n_batch - (f.n_batch // 2 if f.scene.sample_pattern != "random"
                     else 0)
    if scene == "smoke":
        assert bool((dist_to(x, JET_CENTER) < 0.1).any())
    if scene == "karman":
        # round 0 left some slot inside the obstacle in some batch
        first = [f.scene.fluid_mask(sampling.random_points(
            KEY.fold_in(i).fold_in(0), n, f.scene.scene_size))
            for i in range(K)]
        assert not all(bool(m.all()) for m in first)
    if scene == "jpipe":
        assert bool((w == 0.0).any()) and bool((w == 1.0).any())


@pytest.mark.parametrize("scene, res, phase, flag, pattern", [
    ("taylorgreen", 16, "advect", False, "random"),
    ("smoke", 64, "advect", False, "random"),
    ("karman", 32, "advect", False, "random"),
    ("jpipe", 16, "advect", False, "random"),
    ("smoke", 64, "advect", True, "random"),
    ("taylorgreen", 16, "project", False, "random"),
    ("karman", 16, "advect", False, "random+uniform"),
    ("taylorgreen", 16, "advect", False, "uniform"),
])
def test_grouped_pool_is_the_loops(scene, res, phase, flag, pattern):
    f = _fluid(scene, res, pattern)
    bf = _batches(f, phase, flag)
    with torch.no_grad():
        want = _loop_pool(f, KEY, bf)
        got = F._build_pool(f, KEY, bf, G)
    _exercised(f, scene, want)
    for name, a, b in zip("x A c target w".split(), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("x", "w"):
            assert torch.equal(a, b), name
        else:
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-6 * scale, name


def test_source_batches_take_the_loop():
    """The source fit draws one key a batch for its own jitter: its
    pool is the batches one by one."""
    f = _fluid("smoke", 16)
    bf = F._SourceBatches(f, f.scene.bdry_eps, 0)
    with torch.no_grad():
        want = _loop_pool(f, KEY, bf)
        got = F._build_pool(f, KEY, bf, G)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scene, group", [
    ("taylorgreen", 512),            # 4,096 points a batch: the whole pool
    ("smoke", 128),                  # 16,384: 2^21 points a pass
    ("karman", 128),
    ("jpipe", (1 << 25) // ((1 << 14) * 48)),  # a soup of 48 segments
])
def test_group_size_follows_the_shapes(scene, group):
    f = F.NeuralFluid(get_scene(scene), device="cpu", projection="wost")
    assert f.fit_pool == 512
    assert F._pool_group(f) == group
    f.fit_pool = 5
    assert F._pool_group(f) == min(5, group)


def test_smoke_draws_its_jitter_once_a_group(monkeypatch):
    """apply_boundary on a (G, B, 3) group draws the jet jitter once, at
    shape (B,), and gives each batch what it gives that batch alone."""
    scene = get_scene("smoke")
    gen = torch.Generator().manual_seed(8)
    B = 64
    x = torch.tensor(JET_CENTER) + 0.2 * (torch.rand(3, B, 3, generator=gen)
                                          - 0.5)
    vel = torch.randn(3, B, 3, generator=gen)
    draws, shapes = [], []
    span, uniform = keys.span, Key.uniform

    def counted(name, device=None):
        draws.append(name)
        return span(name, device)

    def seen(self, shape, *a, **k):
        shapes.append(tuple(shape))
        return uniform(self, shape, *a, **k)
    monkeypatch.setattr(keys, "span", counted)
    monkeypatch.setattr(Key, "uniform", seen)
    sink = {}
    with spans.bound(sink):
        got = apply_boundary(scene, vel, x, eps=0.05, t=4, key=Key(7),
                             group_dims=1)
    assert draws == ["key_draw"] and shapes == [(B,)]
    assert sink["key_draw"] > 0.0
    one = torch.stack([apply_boundary(scene, vel[g], x[g], eps=0.05, t=4,
                                      key=Key(7)) for g in range(3)])
    assert len(draws) == 4
    assert bool((dist_to(x, JET_CENTER) < 0.1).any())
    assert torch.equal(got, one)
