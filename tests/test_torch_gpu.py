"""Card-only tests of the port's CUDA kernels (marker `gpu`).

The CUDA kernels have no CPU mode, so these skip without a card. They
import neither JAX nor the parity helpers, so they also run on a machine
that has a card and no JAX; the suite's conftest.py configures JAX, so
leave it out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Each test holds a kernel against its plain version on the same card (the
fit against `reference_adam_fit`, at the scenes' shape families and at
deeper nets, the gathers against `reference_gather_rows`), with inputs
made from a numpy seed; the fit also for bit-identical repeats and for a
refused launch. One more holds a small karman WoSt chunk on the card
against the same chunk on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

from nmcfluid_torch.ops import radial_tables as rt
from nmcfluid_torch.sim import fitkernel as fk
from nmcfluid_torch.sim.fitprobe import make_problem
from nmcfluid_torch.wost import pallas_probe as pp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


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


@pytest.mark.parametrize("shape, n_sm, mode", [
    # deeper than any scene: the plan's own choice at each, checked
    (dict(D_in=3, D_out=3, H=128, Lh=4, B=4096), None,
     (True, 2, False)),                # recompute, two weight buffers
    (dict(D_in=2, D_out=2, H=128, Lh=9, B=4096), None,
     (True, 1, False)),                # one buffer, two Adam passes
    (dict(D_in=2, D_out=2, H=128, Lh=9, B=4096), 8,
     (True, 1, True)),                 # 8 blocks: moments in global memory
])
def test_deep_nets_match_twin_on_card(cuda, monkeypatch, shape, n_sm, mode):
    """The kernel where sin and cos do not fit shared memory (z kept in the
    global stash and sin and cos recomputed), where the Adam slice takes
    passes, and where the moments leave shared memory: 25 iterations at
    lr 1e-4, params to rtol 2e-4 / atol 1e-3 as the deep families, the
    loss to 1e-2."""
    if n_sm is not None:
        monkeypatch.setattr(fk, "_sm_count", lambda dev: n_sm)
    cfg, params, pool = make_problem(cuda, **shape)
    K, B, D_in, D_out, H, Lh = fk._shapes(params, pool)
    plan = fk.fit_plan(D_in, D_out, H, Lh, B, K, 25, fk._sm_count(cuda))
    assert (plan.recompute, plan.n_wbuf, plan.moments_global) == mode
    if Lh == 9 and n_sm is None:
        assert plan.chunk > plan.pass_cols
    p_k, l_k = fk.fused_adam_fit(params, cfg, pool, 25, 1e-4)
    p_r, l_r = fk.reference_adam_fit(params, cfg, pool, 25, 1e-4)
    _assert_params_close(p_k, p_r, 1e-3)
    torch.testing.assert_close(l_k, l_r, rtol=1e-2, atol=1e-9)


def test_two_calls_are_bit_identical_on_card(cuda):
    """No float atomics: the same inputs give the same bits, parameters
    and loss, over a fit that cycles the pool (TG shape family)."""
    cfg, params, pool = make_problem(cuda, H=64, Lh=6, K=3, B=4096, seed=5)
    p_a, l_a = fk.fused_adam_fit(params, cfg, pool, 40, 1e-3)
    p_b, l_b = fk.fused_adam_fit(params, cfg, pool, 40, 1e-3)
    assert torch.equal(l_a, l_b)
    for (a, b), (c, d) in zip(p_a, p_b):
        assert torch.equal(a, c) and torch.equal(b, d)


def test_grid_that_cannot_be_co_resident_raises(cuda, monkeypatch):
    """A plan for more blocks than the card holds at once is refused by
    the cooperative launch: the wrapper raises and counts no launch."""
    real = fk._sm_count(cuda)
    monkeypatch.setattr(fk, "_sm_count", lambda dev: 100 * real)
    cfg, params, pool = make_problem(cuda, K=1, B=32 * 3000)
    assert fk.fit_plan(2, 2, 64, 2, 32 * 3000, 1, 3, 100 * real).G == 3000
    before = fk.launches
    with pytest.raises(RuntimeError, match="co-resident"):
        fk.fused_adam_fit(params, cfg, pool, 3, 1e-3)
    assert fk.launches == before


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


def test_karman_wost_chunk_on_card_matches_cpu(cuda):
    """One small karman pressure chunk (the channel's walls, its circle,
    walks escaping through the open inlet and outlet) on the card against
    the CPU with the same keys: the divergence grid of a (64, 26) karman
    grid at rtol 1e-4 / atol 5e-5, the same cloud and valid flags, and p /
    grad p at the gen tolerances of tests/test_gen.py (same streams, other
    sum order)."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim import fluid as tfluid
    from nmcfluid_torch.utils.keys import Key
    kw = dict(sample_resolution=16, wost_resolution=16, div_resolution=64,
              n_walks=48, max_n_iters=50, fit_pool=8)
    gpu = tfluid.NeuralFluid(get_scene("karman"), device=cuda, **kw)
    cpu = tfluid.NeuralFluid(get_scene("karman"), device="cpu", **kw)
    params = gpu.init_state(3).params
    params_cpu = [(W.cpu(), b.cpu()) for W, b in params]
    eps = gpu.scene.bdry_eps / 2
    div_g = tfluid._divergence_grid(gpu, params, eps, 1)
    div_c = tfluid._divergence_grid(cpu, params_cpu, eps, 1)
    assert div_g.shape == (64, 26)
    torch.testing.assert_close(div_g.cpu(), div_c, rtol=1e-4, atol=5e-5)
    pts_g, valid_g, p_g, g_g = tfluid._pressure_solve(gpu, (div_g,), Key(11))
    pts_c, valid_c, p_c, g_c = tfluid._pressure_solve(cpu, (div_g.cpu(),),
                                                      Key(11))
    torch.testing.assert_close(pts_g.cpu(), pts_c, rtol=2e-7, atol=0)
    assert torch.equal(valid_g.cpu(), valid_c)
    torch.testing.assert_close(p_g.cpu(), p_c, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(g_g.cpu(), g_c, rtol=2e-3, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _radial_table():
    return rt.pack_quads(rt.build_table(2)).reshape(-1, 4).astype(np.float32)


def _extreme_table(rows=32512, seed=0):
    """Random float32 bit patterns (nan and inf among them), with rows of
    +-0.0, the smallest subnormal, 1 + 2^-23, +-3.4e38 and +-inf on the
    first and last Z rows."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, (rows, 4), dtype=np.uint64).astype(
        np.uint32)
    special = np.array([0.0, -0.0, 1.4e-45, 1 + 2 ** -23, 3.4e38, -3.4e38,
                        np.inf, -np.inf], np.float32).view(np.uint32)
    bits[:2] = special.reshape(2, 4)
    bits[-2:] = special[::-1].reshape(2, 4)
    return bits.view(np.float32)


def _gather_inputs(dev, kind, n=65536, seed=0):
    """The (32512, 4) radial table, a random normal one or the extreme one,
    and n random int32 rows."""
    rng = np.random.default_rng(seed)
    table = {"radial": _radial_table, "extreme": _extreme_table}.get(
        kind, lambda: rng.standard_normal(pp.ONEHOT_TABLE).astype(
            np.float32))()
    idx = rng.integers(0, table.shape[0], n).astype(np.int32)
    return torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)


def _edge_inputs(dev, case):
    """(table, idx, reps) of one edge case; the kernel's last repeat must
    give table[(idx + reps - 1) % R]."""
    n = {"one_block": 1024, "three_blocks": 3 * 1024,
         "ragged": 9 * 1024}.get(case, 65536)
    table, idx = _gather_inputs(dev, "extreme" if case == "extreme"
                                else "random", n, seed=7)
    if case == "one_bucket":            # every lane on one quad column
        idx.fill_(12345)
    elif case == "end_rows":            # the first and last Z rows only
        idx = torch.where(idx % 2 == 0, idx % 256, 126 * 256 + idx % 256)
    elif case == "extreme":             # the special rows, every one
        idx[:4] = torch.tensor([0, 1, 32510, 32511], device=dev)
    return table, idx.contiguous(), 3 if case == "reps" else 1


def _bits(x):
    return x.view(torch.int32)


_GATHER_CASES = ("probe", "one_block", "three_blocks", "ragged",
                 "one_bucket", "end_rows", "reps", "extreme")


@pytest.mark.parametrize("case", _GATHER_CASES)
@pytest.mark.parametrize("variant", pp.VARIANTS)
def test_gather_kernel_equals_plain_on_card(cuda, variant, case):
    """Bit-exact equality with table[idx] (a gather moves values unchanged;
    onehot's u8 sums have one nonzero term), one launch counted per call.
    "probe": the probe's n = 65,536 on both tables, against the plain
    version too, and inputs the kernel does not take raise ValueError on
    the card with no launch counted. The edge cases: n = 1024 (one block),
    n = 3 * 1024 and 9 * 1024 (onehot's last chunk of 4096 lanes ragged),
    every index the same (one onehot column holds every lane), only the
    first and last Z rows, three repeats through `_launch` (offsets 0, 1,
    2), and a table of +-0.0, a subnormal, 1 + 2^-23, +-3.4e38, +-inf and
    random bit patterns (nan among them)."""
    if case != "probe":
        table, idx, reps = _edge_inputs(cuda, case)
        R = table.shape[0]
        want = table[(idx.long() + reps - 1) % R]
        before = pp.launches[variant]
        if reps == 1:
            got = pp.gather_rows(table, idx, variant)
        else:
            out = pp._empty_out(table, idx.shape[0], variant)
            pp._launch(variant, pp._kernel_table(table, variant), idx, out,
                       R, reps=reps)
            got = out.T if variant == "lanes" else out
        torch.cuda.synchronize()
        assert pp.launches[variant] == before + reps
        assert got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))
        return
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
    if variant in ("lanes", "scalar", "onehot"):  # 16-byte index loads
        bad.append((table, torch.empty(idx.numel() + 4, dtype=torch.int32,
                                       device=cuda)[1:-3].copy_(idx)))
    if variant == "onehot":
        bad.append((table[:1024].contiguous(), idx % 1024))
    before = pp.launches[variant]
    for t, i in bad:
        with pytest.raises(ValueError):
            pp.gather_rows(t, i, variant)
    assert pp.launches[variant] == before


# every lanes plan the sweep on the card chose among (PERF.md), forced
_FORCED_PLANS = [dict(per_thread=g, threads=t) for g in pp.LANES_PER_THREAD
                 for t in (512, 1024)]


@pytest.mark.parametrize("n", [9 * 1024, 65536])
@pytest.mark.parametrize("force", _FORCED_PLANS,
                         ids=lambda f: f"{f['per_thread']}x{f['threads']}")
def test_gather_forced_plan_on_card(cuda, force, n):
    """Each forced lanes plan, bit for bit on the extreme-value table over
    three repeats (offsets 0, 1, 2; the special rows and the last row,
    which the offsets wrap, indexed), one launch counted per repeat; n =
    9 * 1024 leaves the last chunk of most plans ragged."""
    table, idx = _gather_inputs(cuda, "extreme", n, seed=11)
    R = table.shape[0]
    idx[:5] = torch.tensor([0, 1, 32510, 32511, R - 1], device=cuda)
    out = pp._empty_out(table, n, "lanes")
    before = pp.launches["lanes"]
    pp._launch("lanes", pp._kernel_table(table, "lanes"), idx, out, R,
               reps=3, plan=pp.lanes_plan(n, R, pp._sm_count(cuda), **force))
    torch.cuda.synchronize()
    assert pp.launches["lanes"] == before + 3
    assert torch.equal(_bits(out.T), _bits(table[(idx.long() + 2) % R]))


@pytest.mark.parametrize("rows", [pp.LANES_R_MAX, pp.LANES_R_MAX + 1,
                                  70001])
def test_lanes_table_past_the_staging_limit_on_card(cuda, rows):
    """A table whose transposed row fills a block's shared memory is
    staged, bit for bit; one row longer (or an R that is not a multiple of
    4, whose transpose is padded) raises ValueError with no launch
    counted, while rows takes it."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((rows, 4)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, rows, 65536).astype(
        np.int32)).to(cuda)
    idx[0] = rows - 1
    before = pp.launches["lanes"]
    if rows <= pp.LANES_R_MAX:
        got = pp.gather_rows(table, idx, "lanes")
        torch.cuda.synchronize()
        assert pp.launches["lanes"] == before + 1
        assert torch.equal(got, table[idx.long()])
    else:
        with pytest.raises(ValueError):
            pp.gather_rows(table, idx, "lanes")
        assert pp.launches["lanes"] == before
        assert torch.equal(pp.gather_rows(table, idx, "rows"),
                           table[idx.long()])
