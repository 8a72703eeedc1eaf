"""`fit_wide_launches` on the CPU: the program counts each fit-kernel launch
whose plan runs the 4 x 4 micro-tiles (1) or the narrow ones (0) where it
makes the plan, with no card (the launch itself replaced), and the CPU
twin as 0; the metric reads the frame's count, and nothing from a program
without the counter; BENCHMARK.json lists it in the three cells."""
import types

import pytest
import torch

from nmcbench import run as R

# (D_in, D_out, H, Lh, B) of the cells' fits, and the launches they count
SHAPES = {"smoke.spectral": ((3, 3, 64, 5, 16384), 1),
          "karman.spectral": ((2, 2, 128, 2, 16384), 1),
          "tg.spectral": ((2, 2, 64, 6, 4096), 0)}


def _fit_inputs(D_in, D_out, H, Lh, B):
    from nmcfluid_torch.models.siren import SirenConfig
    cfg = SirenConfig(D_in, D_out, num_hidden_layers=Lh, hidden_features=H)
    dims = [(D_in, H)] + [(H, H)] * Lh + [(H, D_out)]
    params = [(torch.zeros(fi, fo), torch.zeros(fo)) for fi, fo in dims]
    pool = (torch.zeros(1, B, D_in), torch.zeros(1, B, D_out, D_out),
            torch.zeros(1, B, D_out), torch.zeros(1, B, D_out),
            torch.ones(1, B))
    return cfg, params, pool


@pytest.mark.parametrize("cell", tuple(SHAPES))
def test_the_fit_counts_its_wide_launches(cell, monkeypatch):
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.utils import spans
    shape, want = SHAPES[cell]
    cfg, params, pool = _fit_inputs(*shape)
    plans = []
    monkeypatch.setattr(fk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(fk, "run_plan", lambda plan, p, pl, lr: (
        plans.append(plan) or (p, torch.zeros(()))))
    sink = {}
    with spans.bound(sink):
        fk._cuda_adam_fit(params, cfg, pool, 10, 1e-3)
        fk._cuda_adam_fit(params, cfg, pool, 10, 1e-3)
    assert sink == {"fit_wide_launches": 2 * want}
    assert [p.wide for p in plans] == [bool(want)] * 2
    metric = R.load_module(f"{R.HERE}/metrics/fit_wide_launches.py", "m")
    frame = types.SimpleNamespace(stage_s=dict(sink))
    assert metric.read(frame) == 2 * want
    assert metric.read(types.SimpleNamespace(stage_s={})) is None


def test_the_twin_counts_none():
    from nmcfluid_torch.sim import fitkernel as fk
    from nmcfluid_torch.utils import spans
    cfg, params, pool = _fit_inputs(2, 2, 32, 1, 64)
    sink = {}
    with spans.bound(sink):
        fk.fused_adam_fit(params, cfg, pool, 2, 1e-3)
    assert sink == {"fit_wide_launches": 0}


def test_every_cell_lists_the_metric():
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        names = [m["name"] for m, _ in
                 R.Cell(w["name"], bench=bench).metrics("per_layer")]
        assert "fit_wide_launches" in names, w["name"]
