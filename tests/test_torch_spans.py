"""The port's spans (nmcfluid_torch/utils/spans.py) on the CPU, at tiny sizes.

With tracing off a span reads no clock, opens no profiler range and never
synchronizes; with `profile` on, a step fills stage_times with the stages
of `_timed` and the spans inside the fits (pool_build, head_solve,
fit_targets, bc_affine, key_draw), each held inside what holds it, and
gives the same parameters to the bit; under torch.profiler with profile
off, the spans are "stage:" ranges nested inside the fit's stage; an
instance override of `_timed`, as the benchmark installs, still sees every
stage. The counter `count` adds to a bound sink only, and a step counts
its pool builds' grouped passes, 2 x ceil(fit_pool / G).
"""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_parity  # noqa: F401  (one torch thread per worker)
from nmcfluid_torch.scenes import get_scene
from nmcfluid_torch.sim import fluid as fluid_mod
from nmcfluid_torch.sim.fluid import NeuralFluid
from nmcfluid_torch.utils import spans
from nmcfluid_torch.utils.keys import Key

SPANS = ("pool_build", "head_solve", "fit_targets", "bc_affine", "key_draw")
SIZES = dict(max_n_iters=6, sample_resolution=8, wost_resolution=8,
             div_resolution=16, n_walks=8, fit_pool=3, ls_head=2,
             device="cpu")


def _fluid(scene, **over):
    return NeuralFluid(get_scene(scene),
                       **{**SIZES, "projection": "spectral", **over})


def _step(f, seed=0):
    """add_source then one step from init_state(seed)."""
    return f.step(f.add_source(f.init_state(seed)))


def _flat(state):
    return torch.cat([t.reshape(-1) for pair in state.params for t in pair])


def _refuse(*_a, **_k):
    raise AssertionError("a span read a clock, opened a range or synced")


def test_tracing_off_reads_no_clock_opens_no_range(monkeypatch):
    for name in ("_clock", "_sync", "_range"):
        monkeypatch.setattr(spans, name, _refuse)
    f = _fluid("smoke")
    _step(f)
    assert f.stage_times == {}


def test_count_costs_nothing_with_nothing_bound(monkeypatch):
    """As a span: with nothing bound a count reads no clock, opens no
    range and records nothing; under a profiler with no sink it records
    nothing either; with a sink bound it adds to it."""
    for name in ("_clock", "_sync", "_range"):
        monkeypatch.setattr(spans, name, _refuse)
    assert spans._state is None
    spans.count("pool_passes")
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.bound(None):
            spans.count("pool_passes")
    sink = {}
    with spans.bound(sink):
        spans.count("pool_passes")
        spans.count("pool_passes", 3)
    spans.count("pool_passes")
    assert sink == {"pool_passes": 4}


@pytest.mark.parametrize("points", [None, 2 * 64])
@pytest.mark.parametrize("scene", ["taylorgreen", "smoke"])
def test_a_step_counts_its_pool_passes(scene, points, monkeypatch):
    """fit_pool 3 of 64-point batches: one pass a fit at the module's
    bound, two (a group of 2, then of 1) at 128 points a pass."""
    if points:
        monkeypatch.setattr(fluid_mod, "_POOL_POINTS", points)
    f = _fluid(scene)
    group = fluid_mod._pool_group(f)
    assert group == (2 if points else 3)
    s = f.add_source(f.init_state(0))
    f.profile = True
    f.step(s)
    assert f.stage_times["pool_passes"] == 2 * math.ceil(3 / group)


@pytest.mark.parametrize("scene", ["taylorgreen", "smoke"])
def test_profile_fills_every_span_inside_its_stage(scene):
    f = _fluid(scene)
    s = f.add_source(f.init_state(0))
    f.profile = True
    f.stage_times = {}
    f.step(s)
    st = f.stage_times
    assert set(SPANS) <= set(st) and all(st[k] > 0.0 for k in SPANS)
    assert "source_fit" not in st
    assert st["advect_fit"] + st["project_fit"] >= st["pool_build"] \
        + st["head_solve"]
    assert st["pool_build"] + st["head_solve"] >= st["fit_targets"] \
        + st["bc_affine"]


@pytest.mark.parametrize("scene", ["taylorgreen", "smoke"])
def test_pool_build_holds_its_targets_and_affine_map(scene):
    """Without the head solve every batch is the pool's: its targets and
    affine maps lie inside the pool build."""
    f = _fluid(scene, ls_head=0)
    f.profile = True
    f.step(f.init_state(0))
    st = f.stage_times
    assert "head_solve" not in st
    assert st["pool_build"] >= st["fit_targets"] + st["bc_affine"]


@pytest.mark.parametrize("scene", ["taylorgreen", "smoke"])
def test_profile_on_and_off_give_the_same_parameters(scene):
    on, off = _fluid(scene), _fluid(scene)
    on.profile = True
    a, b = _step(on), _step(off)
    assert on.stage_times and not off.stage_times
    assert torch.equal(_flat(a), _flat(b))
    assert torch.equal(a.P, b.P)


def _ranges(prof):
    """[(name without "stage:", start us, end us)] of the window's stage
    ranges."""
    return [(e.name[6:], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("stage:")]


@pytest.mark.parametrize("scene", ["taylorgreen", "smoke"])
def test_profiler_ranges_nest_inside_the_fit_stages(scene):
    f = _fluid(scene)
    s = f.add_source(f.init_state(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f.step(s)
    assert f.stage_times == {}                  # profile stays off
    rs = _ranges(prof)
    fits = [r for r in rs if r[0] in ("advect_fit", "project_fit")]
    adv = [r for r in fits if r[0] == "advect_fit"]
    assert len(adv) == 1 and len(fits) == 2

    def inside(r, outer):
        return any(o[1] <= r[1] and r[2] <= o[2] for o in outer)
    for name in SPANS:
        mine = [r for r in rs if r[0] == name]
        assert any(inside(r, adv) for r in mine), name
        if name != "key_draw":
            # key draws also run outside the fits (the pressure cloud)
            assert all(inside(r, fits) for r in mine), name
    pools = [r for r in rs if r[0] == "pool_build"]
    for name in ("fit_targets", "bc_affine"):
        assert any(inside(r, pools) for r in rs if r[0] == name), name


def _draw(key, kind):
    if kind == "uniform":
        return key.uniform((5, 3), "cpu")
    if kind == "normal":
        return key.normal((7,), "cpu")
    if kind == "randint":
        return key.randint((6,), 2, 40, "cpu")
    return key.categorical(torch.zeros(4, 3), (4,))


@pytest.mark.parametrize("kind", ["uniform", "normal", "randint",
                                  "categorical"])
def test_each_key_draw_is_a_span(kind):
    key, sink = Key(123456789012345), {}
    outside = _draw(key, kind)
    with spans.bound(sink):
        inside = _draw(key, kind)
    assert set(sink) == {"key_draw"} and sink["key_draw"] > 0.0
    assert torch.equal(inside, outside)
    _draw(key, kind)
    assert set(sink) == {"key_draw"}            # unbound again


def test_key_draw_is_recorded_inside_a_step_not_outside():
    f = _fluid("taylorgreen")
    f.profile = True
    Key(5).uniform((16, 2), "cpu")
    assert f.stage_times == {}
    s = f.init_state(0)
    assert f.stage_times == {}                  # init_state is no entry
    f.step(s)
    assert f.stage_times["key_draw"] > 0.0


@pytest.mark.parametrize("projection, solve", [("spectral", "spectral_solve"),
                                               ("wost", "wost_solve")])
def test_instance_override_of_timed_sees_every_stage(projection, solve):
    """The benchmark's traced frame replaces `_timed` on the instance; the
    override sees every stage and the class's spans still record."""
    f = _fluid("taylorgreen", projection=projection)
    f.profile = True
    seen = []
    timed = f._timed

    def named(name, fn, *args):
        seen.append(name)
        return timed(name, fn, *args)
    f._timed = named
    _step(f)
    stages = ["source_fit", "advect_fit", "div_grid", solve, "project_fit"]
    assert seen == stages
    assert set(stages) | set(SPANS) <= set(f.stage_times)


def test_span_synchronizes_only_a_bound_cuda_device(monkeypatch):
    synced = []
    monkeypatch.setattr(spans, "_sync", synced.append)
    cuda, sink = torch.device("cuda"), {}
    with spans.bound(sink):
        with spans.span("a", cuda):
            pass
        with spans.span("b", torch.device("cpu")):
            pass
        with spans.span("c"):
            pass
    assert synced == [cuda, cuda] and set(sink) == {"a", "b", "c"}
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.bound(None):
            with spans.span("d", cuda):
                pass
    assert synced == [cuda, cuda]               # a range, no sink: no sync
    assert spans._state is None


def test_each_call_binds_the_stage_times_it_finds():
    """The harness and the CLI assign a fresh dict between calls."""
    f = _fluid("taylorgreen")
    f.profile = True
    s = f.add_source(f.init_state(0))
    first = f.stage_times
    f.stage_times = {}
    f.step(s)
    assert set(first) >= {"source_fit", "pool_build"}
    assert "advect_fit" not in first and "advect_fit" in f.stage_times
    f.profile = False
    second = f.stage_times
    f.stage_times = {}
    f.step(s)
    assert f.stage_times == {} and "advect_fit" in second
