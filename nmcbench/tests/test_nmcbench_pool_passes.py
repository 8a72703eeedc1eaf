"""`pool_passes` through the harness at a tiny size on the CPU with
--trace 1, in both spectral cells: it reads the pool builds' grouped passes
a frame, 2 x ceil(fit_pool / G), at the module's bound on a pass's points
and at one that leaves a partial last group, and the check stays correct."""
import math

import pytest

from .conftest import run_tiny, tiny_cell


@pytest.mark.parametrize("points", [None, 3])
@pytest.mark.parametrize("cell", ["smoke.spectral", "tg.spectral"])
def test_pool_passes_counts_the_grouped_passes(cell, points, monkeypatch):
    from nmcfluid_torch.sim import fluid as fluid_mod
    c = tiny_cell(cell)
    s = c.cfg["scene_fields"]
    n_batch, pool = s["sample_resolution"] ** 2, c.cfg["fluid"]["fit_pool"]
    if points:          # batches a pass, as points
        monkeypatch.setattr(fluid_mod, "_POOL_POINTS", points * n_batch)
    group = min(pool, fluid_mod._POOL_POINTS // n_batch)
    assert group == (points or pool)
    result, notes = run_tiny(c, trace=1)
    m = result["metrics"]["pool_passes"]
    assert m["unit"] == "passes/frame"
    assert m["value"] == notes["stage_s"]["pool_passes"] \
        == 2 * math.ceil(pool / group)
    assert result["correct"] is True, result["check"]
