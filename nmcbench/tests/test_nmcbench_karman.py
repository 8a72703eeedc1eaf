"""The karman.spectral cell through the harness at a tiny size on the CPU:
a traced run prints the obstacle's two metrics (obstacle_modes_s, the
span of the circle's modal correction; resample_points, the rejection
sampler's later rounds) and is correct; with the program's circle
correction zeroed, the check fails on p or grad p, and so it does with
each fault the spectral cells' check catches, and so it does with the
fit's faults planted in the projection phase's fit alone (where only
`prj_fit` can see them: `prj_head` re-solves from the program's own
weights, and the grid and the pressure come before that fit); a
program that records neither key gives neither metric; the yardstick's fit work at karman's
shapes (the 2 x 128 net at 128^2 points, read by fit_roofline) is the
port's own count."""
import json
from types import SimpleNamespace

import pytest
import torch

from nmcbench import run as R
from nmcbench.yardstick import peaks, work

from .conftest import run_tiny, tiny_cell
from .test_nmcbench_faults import SPECTRAL

CELL = "karman.spectral"
# a cloud of 16,384 points, some of them near the circle, where the
# correction decides p and grad p
SIZE = dict(wost_resolution=128)


def test_karman_cell_reads_the_obstacle_metrics(capsys):
    result, notes = run_tiny(tiny_cell(CELL, **SIZE), trace=1)
    R.report(result, notes)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metrics, st = line["metrics"], notes["stage_s"]
    assert metrics["obstacle_modes_s"]["unit"] == "s/frame"
    assert metrics["obstacle_modes_s"]["value"] == st["obstacle_modes"] > 0.0
    assert st["spectral_solve"] >= st["obstacle_modes"]
    assert metrics["resample_points"]["unit"] == "points/frame"
    assert metrics["resample_points"]["value"] == st["resample_points"] > 0
    assert line["correct"] is True, line["check"]


def test_dropped_circle_correction_is_caught(monkeypatch):
    from nmcfluid_torch.ops import circle_modes
    real = circle_modes.eval_circle_correction

    def zero(*a, **k):
        q, g = real(*a, **k)
        return torch.zeros_like(q), torch.zeros_like(g)
    monkeypatch.setattr(circle_modes, "eval_circle_correction", zero)
    result, _ = run_tiny(tiny_cell(CELL, **SIZE))
    assert result["correct"] is False, result["check"]
    failed = {k for k, row in result["check"].items()
              if not row["value"] <= row["limit"]}
    assert failed & {"p", "gradp"}, result["check"]


@pytest.mark.parametrize("fault", sorted(SPECTRAL))
def test_spectral_faults_are_caught(fault, monkeypatch):
    from nmcfluid_torch.sim import fluid as fluid_mod
    name, plant = SPECTRAL[fault]
    monkeypatch.setattr(fluid_mod, name, plant(getattr(fluid_mod, name)))
    result, _ = run_tiny(tiny_cell(CELL))
    assert result["correct"] is False, result["check"]


def _in_projection_fit(plant, monkeypatch):
    """Plant a fault of the fused fit in the projection phase's fit alone:
    the advection fit runs the program's own."""
    from nmcfluid_torch.sim import fluid as fluid_mod
    real_fit, real_project = fluid_mod.fused_adam_fit, fluid_mod._fit_project
    faulty, inside = plant(real_fit), []

    def fit(*a, **k):
        return (faulty if inside else real_fit)(*a, **k)

    def project(*a, **k):
        inside.append(True)
        try:
            return real_project(*a, **k)
        finally:
            inside.pop()
    monkeypatch.setattr(fluid_mod, "fused_adam_fit", fit)
    monkeypatch.setattr(fluid_mod, "_fit_project", project)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_projection_fit_faults_are_caught(fault, monkeypatch):
    _in_projection_fit(SPECTRAL[fault][1], monkeypatch)
    result, _ = run_tiny(tiny_cell(CELL))
    failed = {k for k, row in result["check"].items()
              if not row["value"] <= row["limit"]}
    assert result["correct"] is False and "prj_fit" in failed, \
        result["check"]


def test_readers_give_nothing_without_the_program_keys():
    ctx = SimpleNamespace(stage_s={"spectral_solve": 0.01})
    for name in ("obstacle_modes_s", "resample_points"):
        reader = R.load_module(f"{R.HERE}/metrics/{name}.py", "m_" + name)
        assert reader.read(ctx) is None


def test_fit_work_at_karman_matches_the_port():
    from nmcfluid_torch.models.siren import SirenConfig
    from nmcfluid_torch.sim.fitkernel import iteration_work
    from nmcfluid_torch.utils import h100
    cfg = R.load_json(R.HERE, "configs", "karman.json")
    d_in, d_out, h, lh = work.net_shape(cfg)
    assert (h, lh) == (128, 2)
    B = cfg["scene_fields"]["sample_resolution"] ** 2
    port = iteration_work(SirenConfig(d_in, d_out, num_hidden_layers=lh,
                                      hidden_features=h), B)
    assert work.iteration_work(d_in, d_out, h, lh, B) == port
    b, f = work.fit_work(cfg)
    assert peaks.bound_ms(b, f) == h100.bound_ms(b, f)
