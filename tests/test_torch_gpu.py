"""Card-only tests of the port's CUDA kernels (marker `gpu`).

The CUDA kernels have no CPU mode, so these skip without a card. They
import neither JAX nor the parity helpers, so they also run on a machine
that has a card and no JAX; the suite's conftest.py configures JAX, so
leave it out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each test holds a kernel against its plain version on the same card (the
fit against `reference_adam_fit`, the gathers against
`reference_gather_rows`), with inputs made from a numpy seed.
"""
import functools

import numpy as np
import pytest
import torch

from nmcfluid_torch.models.siren import SirenConfig, init_siren
from nmcfluid_torch.ops import radial_tables as rt
from nmcfluid_torch.sim import fitkernel as fk
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost import pallas_probe as pp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def make_problem(dev, *, D_in=2, D_out=2, H=64, Lh=2, K=2, B=4096, seed=0):
    """SIREN params from the port's initializer and a pool from numpy with
    the distributions of tests/test_fitkernel.py::make_problem."""
    cfg = SirenConfig(D_in, D_out, num_hidden_layers=Lh, hidden_features=H)
    params = init_siren(Key(seed), cfg, dev)
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    pool = (f32(rng.uniform(-1.0, 1.0, (K, B, D_in))),
            f32(rng.normal(size=(K, B, D_out, D_out)) * 0.5),
            f32(rng.normal(size=(K, B, D_out)) * 0.1),
            f32(rng.normal(size=(K, B, D_out)) * 0.2),
            f32(rng.uniform(size=(K, B)) > 0.25))
    return cfg, params, pool


def _assert_params_close(got, want, atol):
    for (a, b), (c, d) in zip(got, want):
        torch.testing.assert_close(a, c, rtol=2e-4, atol=atol)
        torch.testing.assert_close(b, d, rtol=2e-4, atol=atol)


@pytest.mark.parametrize("shape", [
    # the shape families of tests/test_fitkernel.py at the scenes' own
    # batch sizes; atol as there: 1e-3 for the deep nets, whose Adam
    # steps turn last-ulp gradient differences into O(lr) moves
    dict(D_in=2, D_out=2, H=64, Lh=6, B=4096, atol=1e-3),     # taylorgreen
    dict(D_in=2, D_out=2, H=128, Lh=2, B=16384, atol=2e-6),   # karman
    dict(D_in=3, D_out=3, H=64, Lh=5, B=16384, atol=1e-3),    # smoke
    dict(D_in=3, D_out=3, H=128, Lh=2, B=16384, atol=2e-6),   # karman3d
    dict(D_in=2, D_out=2, H=64, Lh=2, B=1000, atol=2e-6),     # ragged tile
])
def test_kernel_matches_twin_on_card(cuda, shape):
    """25 iterations at lr 1e-3: params to rtol 2e-4, the loss to 1e-2."""
    shape = dict(shape)
    atol = shape.pop("atol")
    cfg, params, pool = make_problem(cuda, **shape)
    p_k, l_k = fk.fused_adam_fit(params, cfg, pool, 25, 1e-3)
    p_r, l_r = fk.reference_adam_fit(params, cfg, pool, 25, 1e-3)
    _assert_params_close(p_k, p_r, atol)
    torch.testing.assert_close(l_k, l_r, rtol=1e-2, atol=1e-9)


def test_pool_cycling_and_lr_array_on_card(cuda):
    """Batch i % K with batch 1 weightless (zero-gradient steps that still
    decay the moments) and a decaying per-iteration lr array."""
    cfg, params, pool = make_problem(cuda, K=2, B=2048, seed=3)
    x, A, c, tgt, w = pool
    w = w.clone()
    w[1] = 0.0
    pool = (x, A, c, tgt, w)
    lr = 1e-3 * 0.85 ** torch.arange(12, dtype=torch.float32)
    p_k, _ = fk.fused_adam_fit(params, cfg, pool, 12, lr)
    p_r, _ = fk.reference_adam_fit(params, cfg, pool, 12, lr)
    _assert_params_close(p_k, p_r, 2e-6)


def test_launch_counter_and_no_fallback(cuda):
    """One count per kernel launch; inputs the kernel does not take raise
    on a CUDA tensor instead of falling back, and count nothing."""
    cfg, params, pool = make_problem(cuda, B=512)
    before = fk.launches
    fk.fused_adam_fit(params, cfg, pool, 3, 1e-3)
    assert fk.launches == before + 1
    bad_dtype = (pool[0].double(),) + pool[1:]
    cpu_params = [(W.cpu(), b.cpu()) for W, b in params]
    for p, pl in ((params, bad_dtype), (cpu_params, pool),
                  (params[:-1], pool)):
        with pytest.raises(ValueError):
            fk.fused_adam_fit(p, cfg, pl, 3, 1e-3)
    assert fk.launches == before + 1


@functools.lru_cache(maxsize=None)
def _radial_table():
    return rt.pack_quads(rt.build_table(2)).reshape(-1, 4).astype(np.float32)


def _gather_inputs(dev, kind, n=65536, seed=0):
    """The (32512, 4) radial table or a random normal one, and n random
    int32 rows."""
    rng = np.random.default_rng(seed)
    table = _radial_table() if kind == "radial" else \
        rng.standard_normal(pp.ONEHOT_TABLE).astype(np.float32)
    idx = rng.integers(0, table.shape[0], n).astype(np.int32)
    return torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("variant", pp.VARIANTS)
def test_gather_kernel_equals_plain_on_card(cuda, variant):
    """Exact equality at the probe's n = 65,536 on both tables (a gather
    moves values unchanged; onehot's sums have one nonzero term), one
    launch counted per call, and inputs the kernel does not take raise
    ValueError on the card with no launch counted."""
    for kind in ("random", "radial"):
        table, idx = _gather_inputs(cuda, kind)
        before = pp.launches[variant]
        got = pp.gather_rows(table, idx, variant)
        torch.cuda.synchronize()
        assert pp.launches[variant] == before + 1
        assert torch.equal(got, pp.reference_gather_rows(table, idx,
                                                         variant))
    past_end = idx.clone()
    past_end[7] = table.shape[0]
    misaligned = torch.empty(table.numel() + 1, device=cuda)[1:].view(-1, 4)
    misaligned.copy_(table)
    bad = [(table, idx[:1000]), (table.double(), idx), (table, idx.long()),
           (table.cpu(), idx), (table, idx.cpu()), (table, past_end),
           (table, -idx - 1)]
    if variant in ("rows", "scalar"):
        bad.append((misaligned, idx))
    if variant == "onehot":
        bad.append((table[:1024].contiguous(), idx % 1024))
    before = pp.launches[variant]
    for t, i in bad:
        with pytest.raises(ValueError):
            pp.gather_rows(t, i, variant)
    assert pp.launches[variant] == before
