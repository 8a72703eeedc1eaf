"""The fit kernel's launch plan (sim/fitkernel.py::fit_plan) on the CPU.

The persistent kernel in csrc/fitkernel.cu takes its plan from Python: how
many blocks, which point tiles and which parameters each block owns, which
buffers, and the shared memory they need. These tests hold the plan to
that contract for the wrapper's shape families; the kernel itself runs
only on a card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import pathlib
import re

import pytest
import torch

from nmcfluid_torch.sim import fitkernel as fk
from nmcfluid_torch.sim import fitprobe

CU = pathlib.Path(fk.__file__).resolve().parents[1] / "csrc" / "fitkernel.cu"
SM_COUNTS = (132, 114)          # H100 SXM, H100 PCIe
# (D_in, D_out, H, Lh, B): the scenes' shape families, then deeper nets
# than any scene ships, which the kernel takes too
FAMILIES = {**{k: v[0] for k, v in fitprobe.SHAPES.items()},
            "deep128": (2, 2, 128, 9, 16384),
            "deep96": (3, 3, 96, 40, 4096),
            "deep128x160": (2, 2, 128, 160, 4096),
            "deep32": (2, 2, 32, 60, 1000)}


def _plan(shape, n_sm, **kw):
    D_in, D_out, H, Lh, B = FAMILIES[shape]
    return fk.fit_plan(D_in, D_out, H, Lh, B, 512, 10000, n_sm, **kw)


def _check_plan(plan, n_sm):
    """Every tile and parameter owned by exactly one block, G <= SMs, and
    shared memory within 227 KB and as the .cu lays it out."""
    assert 1 <= plan.n_work <= plan.G <= n_sm
    tiles = [t for b in range(plan.G) for t in plan.tiles(b)]
    assert sorted(tiles) == list(range(plan.n_tiles))
    assert (plan.n_tiles - 1) * fk._T < plan.B <= plan.n_tiles * fk._T
    # parameter slices: consecutive ranges that tile [0, n_params)
    stop = 0
    for b in range(plan.G):
        r = plan.params(b)
        assert r.start == stop and len(r) <= plan.chunk
        stop = r.stop
    assert stop == plan.n_params
    assert plan.chunk % 4 == 0 and plan.G * plan.chunk >= plan.n_params
    assert plan.pass_cols % 4 == 0
    assert plan.pass_cols <= min(plan.chunk, fk._CHUNK_MAX)
    assert plan.ld_part % 4 == 0 and plan.ld_part >= plan.n_params
    assert plan.Hp % 32 == 0 and plan.H <= plan.Hp <= 128
    assert 1 <= plan.row_groups <= plan.n_work
    assert plan.smem_bytes <= 227 * 1024
    assert plan.smem_bytes == fk._smem_bytes(
        plan.Hp, plan.Lh, plan.chunk, plan.pass_cols, plan.n_wbuf,
        plan.recompute, plan.moments_global, plan.row_groups,
        plan.pass_tiles)
    assert len(plan.array()) == len(fk._PLAN_FIELDS)
    # two tiles a pass only where they make a wide pass, with sin and cos
    # kept, in blocks that own two or more
    assert plan.pass_tiles in (1, 2)
    if plan.pass_tiles == 2:
        assert plan.Hp == 64 and not plan.recompute
        assert plan.tiles_per_block >= 2 and plan.wide
    assert plan.wide == (fk._T * plan.pass_tiles * plan.Hp == 4096)


@pytest.mark.parametrize("n_sm", SM_COUNTS)
@pytest.mark.parametrize("shape", tuple(FAMILIES))
def test_plan_owns_every_tile_and_parameter_once(shape, n_sm):
    _check_plan(_plan(shape, n_sm), n_sm)


@pytest.mark.parametrize("Lh", (0, 7, 40, 200))
@pytest.mark.parametrize("H", (32, 64, 96, 128))
def test_every_depth_fits_a_block(H, Lh):
    """Any depth at H <= 128: sin and cos kept while they fit, else each
    layer's z in the global stash (five shared buffers whatever the depth),
    and the Adam moments in global memory once they do not fit beside."""
    plan = fk.fit_plan(2, 2, H, Lh, 4096, 8, 100, 132)
    _check_plan(plan, 132)
    if Lh >= 40:
        assert plan.recompute
    if plan.recompute:       # no term of the layout grows with depth
        assert plan.smem_bytes == fk._smem_bytes(
            plan.Hp, 1, plan.chunk, plan.pass_cols, plan.n_wbuf, True,
            plan.moments_global, plan.row_groups, 1)


@pytest.mark.parametrize("Lh", (0, 7, 40, 200))
@pytest.mark.parametrize("H", (32, 64, 96, 128))
def test_every_depth_fits_a_block_with_two_tile_passes(H, Lh):
    """test_every_depth_fits_a_block's grid where the blocks own four tiles
    (B = 16,384), so that two-tile passes are open to the plan: within
    shared memory at every depth, and taken at H padded to 64 exactly where
    sin and cos of two tiles fit (forced, they raise elsewhere)."""
    plan = fk.fit_plan(2, 2, H, Lh, 16384, 8, 100, 132)
    _check_plan(plan, 132)
    assert plan.tiles_per_block == 4
    fits = fk._smem_bytes(-(-H // 32) * 32, Lh, plan.chunk, plan.pass_cols,
                          1, False, False, plan.row_groups, 2) \
        <= fk._SMEM_LIMIT
    assert plan.pass_tiles == (2 if H == 64 and fits else 1)
    if plan.pass_tiles == 1 and H != 64:
        with pytest.raises(ValueError):
            fk.fit_plan(2, 2, H, Lh, 16384, 8, 100, 132, pass_tiles=2)


def test_two_tile_passes_where_a_tile_gives_half_a_wide_pass():
    """Smoke (5 x 64, 128 blocks of 4 tiles) takes its tiles two at a
    time, 64 points x 64 units a pass, with one weight buffer (two do not
    fit: 243,600 B); Taylor-Green (one tile a block) and karman (one tile
    already gives 4,096 outputs at Hp = 128) take one; the ragged batch of
    16,344 points leaves its last block three tiles."""
    smoke = _plan("smoke", 132)
    assert (smoke.pass_tiles, smoke.n_wbuf, smoke.recompute, smoke.wide,
            smoke.tiles_per_block) == (2, 1, False, True, 4)
    assert smoke.smem_bytes == 226960
    assert fk._smem_bytes(64, 5, smoke.chunk, smoke.pass_cols, 2, False,
                          False, smoke.row_groups, 2) == 243600
    tg, karman = _plan("tg", 132), _plan("karman", 132)
    assert (tg.pass_tiles, tg.wide, tg.n_wbuf) == (1, False, 2)
    assert (karman.pass_tiles, karman.wide, karman.n_wbuf) == (1, True, 1)
    ragged = fk.fit_plan(3, 3, 64, 5, 16344, 512, 10000, 132)
    assert (ragged.pass_tiles, ragged.n_tiles) == (2, 511)
    assert len(ragged.tiles(ragged.n_work - 1)) == 3
    one = _plan("smoke", 132, pass_tiles=1)
    assert (one.pass_tiles, one.n_wbuf, one.wide) == (1, 2, False)
    for kw in (dict(pass_tiles=2, recompute=True), dict(pass_tiles=3)):
        with pytest.raises(ValueError):
            _plan("smoke", 132, **kw)
    for shape in ("tg", "karman"):
        with pytest.raises(ValueError):
            _plan(shape, 132, pass_tiles=2)


def test_taylor_green_plan():
    """One 32-point tile per block over 128 blocks; sin and cos kept, two
    weight buffers, the Adam slice in one pass with its moments on chip."""
    plan = _plan("tg", 132)
    assert (plan.G, plan.n_work, plan.tiles_per_block, plan.n_tiles) == \
        (128, 128, 1, 128)
    assert (plan.Hp, plan.chunk, plan.pass_cols, plan.n_params) == \
        (64, 200, 200, 25282)
    assert (plan.recompute, plan.n_wbuf, plan.moments_global) == \
        (False, 2, False)


def test_plan_buffers_follow_shared_memory():
    """Two weight buffers when they fit, then one, then recomputed sin and
    cos, then the moments in global memory: each choice only when the one
    before does not fit."""
    karman = _plan("karman", 132)
    assert (karman.recompute, karman.n_wbuf, karman.tiles_per_block) == \
        (False, 1, 4)
    forced = _plan("karman", 132, recompute=True)   # room for two buffers
    assert (forced.recompute, forced.n_wbuf) == (True, 2)
    deep = fk.fit_plan(2, 2, 128, 4, 4096, 8, 100, 132)
    assert (deep.recompute, deep.n_wbuf, deep.moments_global) == \
        (True, 2, False)
    deeper = _plan("deep128", 132)             # two Adam passes a block
    assert (deeper.recompute, deeper.n_wbuf, deeper.moments_global) == \
        (True, 1, False)
    assert deeper.chunk > deeper.pass_cols == fk._CHUNK_MAX
    few_sms = fk.fit_plan(2, 2, 128, 9, 4096, 8, 100, 8)
    assert (few_sms.G, few_sms.moments_global) == (8, True)


@pytest.mark.parametrize("args", [
    dict(D_in=4), dict(D_out=1), dict(H=0), dict(H=129), dict(Lh=-1),
    dict(B=0), dict(K=0), dict(n_iters=0), dict(n_sm=0),
    dict(H=128, Lh=9, recompute=False),  # kept sin and cos do not fit
])
def test_unsupported_shapes_raise(args):
    kw = dict(D_in=2, D_out=2, H=64, Lh=2, B=4096, K=8, n_iters=100,
              n_sm=132)
    kw.update(args)
    with pytest.raises(ValueError):
        fk.fit_plan(**kw)


def _enum(name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", CU.read_text(),
                     re.S).group(1)
    return [t.strip() for t in body.replace("\n", " ").split(",")
            if t.strip()]


def test_plan_fields_and_phases_match_the_kernel():
    """The int64 plan array and the phase times are read by position on
    the C side: the Python names follow the .cu's enums in order."""
    fields = _enum("PlanField")
    assert fields[-1] == "N_PLAN_FIELDS"
    assert [f[2:].lower() for f in fields[:-1]] == \
        [f.lower() for f in fk._PLAN_FIELDS]
    phases = _enum("Phase")
    assert phases[-1] == "N_PHASES"
    assert [p[3:].lower() for p in phases[:-1]] == list(fk.PHASES)


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        fitprobe.main([])


@pytest.mark.parametrize("fault", tuple(fitprobe.FAULTS))
def test_fault_copies_edit_the_kernel_source(fault):
    """Each fault copy of csrc/fitkernel.cu (fitprobe --faults) finds each
    of its edits once in the source and carries every replacement, and
    leaves the rest of the file as it is."""
    src = CU.read_text()
    got = fitprobe.fault_source(fault)
    for old, new in fitprobe.FAULTS[fault]:
        assert src.count(old) == 1
        assert new in got
        src = src.replace(old, new)
    assert got == src


def test_divergence_probe_needs_a_card(monkeypatch):
    from nmcfluid_torch.sim import divprobe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        divprobe.main([])


def test_chip_smoke_fit_bounds_are_the_swept_ones():
    """chip_smoke.py's fit check on the 2 x 128 nets holds the bounds that
    `fitprobe --key_sweep` reads it against (fitprobe.SMOKE_ATOL): the
    atol against the f32 twin in PATHS, the float64 one in ATOL64."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CU.parents[2] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    paths = {p[0]: p[2] for p in cs.PATHS}
    for name, (atol, atol64) in fitprobe.SMOKE_ATOL.items():
        assert paths[name] == atol, name
        assert cs.ATOL64[name] == atol64, name
    assert set(cs.ATOL64) == set(fitprobe.SMOKE_ATOL)


def test_sweep_shares_take_the_worst_pool_seed_and_both_twins():
    """fitprobe.sweep_shares: a fit's share at a key is the largest, over
    chip_smoke.py's pool seeds, of the atol it needs against the f32 twin
    and against the float64 twin (where the check holds one), each over
    its bound; the f32 twin's own row is not a fit."""
    def fit(t, d):
        return {"twin": {"top": [t]}, "f64": {"top": [d]}}
    res = {
        "chip_smoke.py karman pool seed 0": {
            "atol": (1e-5, 2e-5),
            "keys": {"0": {"twin": {"f64": {"top": [9.0]}},
                           "kernel": fit(5e-6, 1e-5),
                           "drop_row": fit(1e-3, 1e-3)}}},
        "chip_smoke.py karman pool seed 1": {
            "atol": (1e-5, 2e-5),
            "keys": {"0": {"twin": {"f64": {"top": [9.0]}},
                           "kernel": fit(2e-6, 3e-5),
                           "drop_row": fit(2e-3, 1e-3)}}},
        "test_pool_cycling_and_lr_array_on_card": {
            "atol": (4e-6, None),
            "keys": {"0": {"kernel": fit(2e-6, 1.0)},
                     "1": {"kernel": fit(3e-6, 1.0)}}},
    }
    got = fitprobe.sweep_shares(res)
    assert set(got) == {"chip_smoke.py karman",
                        "test_pool_cycling_and_lr_array_on_card"}
    assert got["chip_smoke.py karman"]["kernel"] == pytest.approx([1.5])
    assert got["chip_smoke.py karman"]["drop_row"] == pytest.approx([200.0])
    assert got["test_pool_cycling_and_lr_array_on_card"]["kernel"] == \
        pytest.approx([0.5, 0.75])
