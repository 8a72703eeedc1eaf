"""Parity of the port's gather probe with the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its docstring
runs them without a TPU; the port's side runs the plain versions, which is
what `gather_rows` takes for CPU tensors. Inputs are made with numpy from
a seed and handed to both.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np

from nmcfluid.wost import pallas_probe as j_pp

from nmcfluid_torch.ops import radial_tables as t_rt
from nmcfluid_torch.wost import pallas_probe as t_pp

N = 2048


@functools.lru_cache(maxsize=None)
def _radial_table():
    return t_rt.pack_quads(t_rt.build_table(2)).reshape(-1, 4).astype(
        np.float32)


def _inputs(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    table = _radial_table() if kind == "radial" else \
        rng.standard_normal(t_pp.ONEHOT_TABLE).astype(np.float32)
    idx = rng.integers(0, table.shape[0], n).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("kind", ["random", "radial"])
@pytest.mark.parametrize("variant", t_pp.VARIANTS)
def test_plain_gather_matches_jax(variant, kind):
    """Bit for bit, tolerance 0: a gather moves values unchanged, and the
    one-hot f32 product has one nonzero term in each sum, so neither side
    rounds."""
    table, idx = _inputs(kind)
    want = np.asarray(j_pp.gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                       variant=variant, interpret=True))
    got = t_pp.gather_rows(torch.from_numpy(table), torch.from_numpy(idx),
                           variant)
    assert got.shape == (N, 4)
    assert np.array_equal(to_np(got), want)


def test_rows_gather_is_the_radius_draw_quad():
    """At row i0 * 256 + j0 of the flattened quad table (the probe's
    `walk_indices`), `rows` returns the quad that
    ops/radial_tables.py::sample_t_screened_u gathers as table_quads[i0, j0],
    so the draw built on it is the port's, exactly."""
    quads = torch.from_numpy(t_rt.pack_quads(t_rt.build_table(2)).astype(
        np.float32))
    rng = np.random.default_rng(1)
    Z = torch.from_numpy(np.exp(rng.uniform(np.log(1e-4), np.log(1e5), N))
                         .astype(np.float32))
    u = torch.from_numpy(rng.uniform(0.0, 1.0, N).astype(np.float32))
    # the index arithmetic of sample_t_screened_u
    zi = (torch.log(torch.clamp(Z, t_rt._Z_MIN, t_rt._Z_MAX))
          - t_rt._LOG_Z_MIN) / t_rt._DLOG
    i0 = torch.clamp(torch.floor(zi).to(torch.int64), 0, t_rt._N_Z - 2)
    wi = torch.clamp(zi - i0, 0.0, 1.0)
    uj = u * (t_rt._N_U - 1)
    j0 = torch.clamp(torch.floor(uj).to(torch.int64), 0, t_rt._N_U - 2)
    wj = uj - j0
    rows = t_pp.walk_indices(Z, u)
    assert torch.equal(rows.long(), i0 * (t_rt._N_U - 1) + j0)
    q = t_pp.gather_rows(quads.reshape(-1, 4), rows, "rows")
    assert torch.equal(q, quads[i0, j0])
    t = ((1 - wi) * ((1 - wj) * q[:, 0] + wj * q[:, 1])
         + wi * ((1 - wj) * q[:, 2] + wj * q[:, 3]))
    assert torch.equal(t, t_rt.sample_t_screened_u(quads, Z, u))


@pytest.mark.parametrize("case", ["n_not_a_multiple", "onehot_wrong_table",
                                  "int64_indices", "float64_table",
                                  "index_out_of_range"])
def test_gather_rejects_what_the_kernel_does_not_take(case):
    """The kernel's contract holds on both devices: ValueError, on the CPU
    too, where the plain version alone could have run."""
    table, idx = (torch.from_numpy(a) for a in _inputs("random"))
    variant = "rows"
    if case == "n_not_a_multiple":
        idx = idx[:1000]
    elif case == "onehot_wrong_table":
        table, idx, variant = table[:1024], idx % 1024, "onehot"
    elif case == "int64_indices":
        idx = idx.long()
    elif case == "index_out_of_range":
        idx[7] = table.shape[0]
    else:
        table = table.double()
    with pytest.raises(ValueError):
        t_pp.gather_rows(table, idx, variant)


_FORMS = ("torch", "torch_rows", "torch_lanes", "torch_onehot",
          "torch_quads") + t_pp.VARIANTS


def _check_cpu_main(res, out):
    lines = out.splitlines()
    assert list(res) == list(_FORMS)
    for name, line in zip(_FORMS, lines):
        assert line.split(":")[0].strip() == name
        assert ": OK" in line and "not timed" in line
        assert res[name] == {"ok": True, "ms": None, "err": 0.0}
    assert set(t_pp.PLAIN.values()) <= set(_FORMS)


def test_probe_main_on_cpu(capsys):
    """`--device cpu` runs every form and every baseline as plain versions,
    checks each against table[idx] and times none."""
    res = t_pp.main(["--device", "cpu", "--n", str(N)])
    _check_cpu_main(res, capsys.readouterr().out)


def test_probe_main_on_cpu_radial_table(capsys):
    """The same on the radial table, with the rows the walk's radius draw
    picks: the rows the probe draws span the table's Z range and past both
    ends, so the first and last Z rows are both hit."""
    res = t_pp.main(["--device", "cpu", "--table", "radial", "--n", str(N)])
    _check_cpu_main(res, capsys.readouterr().out)
    table, idx = t_pp.probe_inputs("radial", N, "cpu")
    assert torch.equal(table, torch.from_numpy(_radial_table()))
    i0 = idx // 256
    assert int(i0.min()) == 0 and int(i0.max()) == t_rt._N_Z - 2


def test_probe_profile_needs_the_card():
    with pytest.raises(SystemExit):
        t_pp.main(["--device", "cpu", "--n", str(N), "--profile"])


def test_probe_main_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_pp.main(["--n", str(N)])


# ---- the onehot kernel's plan, table layout and arithmetic, on the CPU


@pytest.mark.parametrize("n_sm", [8, 132])
@pytest.mark.parametrize("n", [1024, 3 * 1024, 9 * 1024, 65536, 100 * 1024,
                               524288])
def test_onehot_plan_covers_every_lane_once(n, n_sm):
    """Chunks of `lanes` lanes (the last may hold fewer) cover [0, n) once
    and the column ranges cover the 256 quad columns once, so each (lane,
    column) pair has one block; no more blocks than SMs unless the plan's
    first choice (chunks of 8192 lanes x 4 ranges) already fills half the
    card; a block's shared memory fits the H100's 227 KB."""
    plan = t_pp.onehot_plan(n, n_sm)
    assert plan.n == n and plan.lanes % t_pp.BLOCK == 0
    assert plan.lanes in (4096, 8192)
    assert plan.ranges in t_pp.ONEHOT_RANGES
    hits = np.zeros(n, np.int64)
    for c in range(plan.chunks):
        hits[c * plan.lanes:min((c + 1) * plan.lanes, n)] += 1
    assert (hits == 1).all()
    cols = np.zeros(t_pp.ONEHOT_J, np.int64)
    J = t_pp.ONEHOT_J // plan.ranges
    for r in range(plan.ranges):
        cols[r * J:(r + 1) * J] += 1
    assert (cols == 1).all()
    assert plan.ctas == plan.chunks * plan.ranges
    assert plan.ctas <= max(n_sm, 4 * -(-n // 8192))
    assert plan.smem_bytes == t_pp.onehot_smem(plan.lanes, plan.ranges) \
        <= t_pp.SMEM_MAX


def test_onehot_plan_at_the_probe_sizes():
    """On the H100's 132 SMs: 16 chunks of 4096 lanes x 8 column ranges
    (128 blocks) at the probe's n, 64 chunks of 8192 x 4 (256 blocks, two an
    SM) at a walk generation's; n = 3 * 1024 and 9 * 1024 leave the last
    chunk of 4096 ragged; a forced chunk and range count are taken as
    given, and what the kernel cannot run is refused."""
    plan = t_pp.onehot_plan
    assert plan(65536, 132)[1:5] == (4096, 8, 16, 128)
    assert plan(524288, 132)[1:5] == (8192, 4, 64, 256)
    assert plan(3 * 1024, 132)[1:5] == (4096, 16, 1, 16)
    assert plan(9 * 1024, 132)[1:5] == (4096, 16, 3, 48)
    assert plan(524288, 132, 2048, 8)[1:5] == (2048, 8, 256, 2048)
    for n, lanes, ranges in ((1000, None, None), (2048, 1536, None),
                             (2048, 32768, None), (2048, 0, None),
                             (2048, None, 2)):
        with pytest.raises(ValueError):
            plan(n, 132, lanes, ranges)


def test_onehot_relayout():
    """onehot_columns: element (j0, z, q) is the padded table's (z, 4 j0 +
    q), Z row 127 zero. onehot_fragments: byte e of word (j0, s, lane 4 g +
    t, c = 2 h + half) is byte 4 (g // 2) + 2 h + g % 2 of column j0's quad
    on Z row 32 s + 16 half + 4 t + e."""
    table = torch.from_numpy(_inputs("random")[0])
    pad = np.zeros((128, 1024), np.float32)
    pad[:127] = table.numpy().reshape(127, 1024)
    cols = t_pp.onehot_columns(table)
    assert cols.shape == (256, 128, 4)
    j0, z, q = np.meshgrid(np.arange(256), np.arange(128), np.arange(4),
                           indexing="ij")
    assert np.array_equal(cols.numpy(), pad[z, 4 * j0 + q])
    frag = t_pp.onehot_fragments(cols)
    assert frag.dtype == torch.int32 and frag.shape == (256, 4, 32, 4)
    got = frag.numpy().view(np.uint8).reshape(256, 4, 32, 4, 4)
    cb = cols.numpy().view(np.uint8).reshape(256, 128, 16)
    j0, s, lane, c, e = np.meshgrid(*(np.arange(k) for k in got.shape),
                                    indexing="ij")
    g, t, h, half = lane // 4, lane % 4, c // 2, c % 2
    assert np.array_equal(got, cb[j0, 32 * s + 16 * half + 4 * t + e,
                                  4 * (g // 2) + 2 * h + g % 2])
    assert torch.equal(t_pp._kernel_table(table, "onehot"), frag)


@pytest.mark.parametrize("variant", [None, "one_kstep", "no_store"])
def test_gather_phases_stamps_the_kernel(variant):
    """The phase probe's copy of csrc/gather.cu finds every text it edits
    once: four clock stamps after the phases' barriers and one at the
    start, two globaltimer reads, and the variant's cut."""
    from nmcfluid_torch.wost import gather_phases
    src = gather_phases.stamped_source(variant)
    assert src.count("clock64()") == 5 and src.count("%%globaltimer") == 2
    assert ("s < 1; ++s" in src) == (variant == "one_kstep")
    assert ("end < 0" in src) == (variant == "no_store")


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


def _bytes(words):
    """uint32 (...,) -> int64 (..., 4), byte e = bits 8 e .. 8 e + 7."""
    return (words[..., None].astype(np.int64) >> (8 * np.arange(4))) & 0xFF


def _emulate_onehot_block(B, rows, mine, J, j_lo, rng):
    """One block of gather_onehot_k: the chunk's lanes `mine` (those whose
    column lies in [j_lo, j_lo + J)) sorted by column in a random order
    within each column, as the shared atomics may leave it; each 16-lane
    tile's u8 A fragments built as the kernel builds them; each
    mma.m16n8k32 as an int64 matmul of the fragments placed by the PTX
    layout; the bytes of lane (g, t)'s rows joined into their word t.
    Returns (lane, word t, bits) of every store."""
    order = rng.permutation(mine)
    order = order[np.argsort(rows[order] & 0xFF, kind="stable")]
    start = np.concatenate([[0], np.cumsum(np.bincount(
        (rows[mine] & 0xFF) - j_lo, minlength=J))])
    tiles = [(j, p) for j in range(J)
             for p in range(start[j], start[j + 1], 16)]
    if not tiles:
        return []
    j_t = np.array([j for j, _ in tiles])
    pos = np.array([p for _, p in tiles])[:, None] + np.arange(16)
    valid = pos < start[j_t + 1][:, None]
    key = order[np.where(valid, pos, 0)]
    i0 = np.where(valid, rows[key] >> 8, 0xFF)                    # (T, 16)
    T, tt, s = len(tiles), np.arange(4), np.arange(4)
    A = np.zeros((T, 4, 16, 32), np.int64)
    for r0 in (0, 8):
        i0r = i0[:, r0:r0 + 8]
        w = np.where(((i0r >> 2) & 3)[..., None] == tt,
                     np.left_shift(1, 8 * (i0r & 3))[..., None], 0)
        for hi in (0, 1):                     # A registers (r0 / 8 + 2 hi)
            a = np.where((i0r >> 4)[:, None, :, None]
                         == (2 * s + hi)[None, :, None, None],
                         w[:, None], 0)       # (T, s, g, t)
            A[:, :, r0:r0 + 8, 16 * hi:16 * hi + 16] = _bytes(a).reshape(
                T, 4, 8, 16)
    D = torch.einsum("tsrk,tshkn->thrn", torch.from_numpy(A),
                     B[torch.from_numpy(j_lo + j_t)]).numpy()  # (T, h, 16, 8)
    assert D.max() <= 0xFF              # one nonzero term in each sum
    stores = []
    g = np.arange(8)[:, None]
    for r0 in (0, 8):
        d = [D[:, h, g + r0, 2 * tt + i] for h in (0, 1) for i in (0, 1)]
        word = d[0] | d[1] << 8 | d[2] << 16 | d[3] << 24      # (T, g, t)
        ln = np.broadcast_to(np.where(valid[:, r0:r0 + 8], key[:, r0:r0 + 8],
                                      -1)[..., None], word.shape)
        m = ln >= 0
        stores.append((ln[m], np.broadcast_to(tt, word.shape)[m], word[m]))
    return stores


def _emulate_onehot_kernel(frag, idx, R, offset, plan, rng):
    """csrc/gather.cu::gather_onehot_k in numpy, register by register, block
    by block of `plan`, with the B fragments read from `frag`. Returns the
    (n, 4) uint32 bits and the count of words stored for each lane."""
    n, Lc, J = plan.n, plan.lanes, t_pp.ONEHOT_J // plan.ranges
    # B[j0, s, h, k, col]: byte e of word (s, lane 4 g + t, 2 h + half)
    # holds k = 16 half + 4 t + e, col g
    B = _bytes(frag.numpy().view(np.uint32).reshape(256, 4, 8, 4, 2, 2))
    B = torch.from_numpy(B.transpose(0, 1, 4, 5, 3, 6, 2).reshape(
        256, 4, 2, 32, 8).copy())
    out = np.zeros((n, 4), np.uint32)
    hits = np.zeros(n, np.int64)
    for c in range(plan.chunks):
        base = c * Lc
        rows = (idx[base:base + Lc].astype(np.int64) + offset) % R
        for r in range(plan.ranges):
            mine = np.flatnonzero((rows & 0xFF) // J == r)
            for st in _emulate_onehot_block(B, rows, mine, J, r * J, rng):
                lane, word_t, bits = st
                out[base + lane, word_t] = bits
                np.add.at(hits, base + lane, 1)
    return out, hits


@pytest.mark.parametrize("kind, lanes, ranges, offset", [
    ("random", None, None, 0), ("radial", None, None, 0),
    ("extreme", None, None, 0), ("extreme", 4096, 4, 2),
    ("random", 8192, 8, 7)])
def test_onehot_mma_emulation_is_exact(kind, lanes, ranges, offset):
    """The kernel's arithmetic, emulated on the CPU with the plan (n = 9 *
    1024: 3 chunks of 4096 lanes x 16 column ranges, the last chunk ragged;
    or a forced plan) and the relaid table, stores each lane's row once and
    moves table[(idx + offset) % R] bit for bit: on both probe tables and on
    a table of extreme and random bit patterns whose special rows (first and
    last Z rows) the indices hit."""
    n = 9 * 1024
    if kind == "extreme":
        table = _extreme_table()
        idx = np.random.default_rng(3).integers(0, 32512, n).astype(np.int32)
        idx[:4] = [0, 1, 32510, 32511]
    else:
        table, idx = _inputs(kind, n)
    R = table.shape[0]
    plan = t_pp.onehot_plan(n, 132, lanes, ranges)
    frag = t_pp._kernel_table(torch.from_numpy(table), "onehot")
    got, hits = _emulate_onehot_kernel(frag, idx, R, offset, plan,
                                       np.random.default_rng(4))
    assert (hits == 4).all()
    want = table.view(np.uint32)[(idx.astype(np.int64) + offset) % R]
    assert np.array_equal(got, want)
