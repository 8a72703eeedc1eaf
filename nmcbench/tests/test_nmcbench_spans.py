"""The program's spans inside the fits, read by the per-layer metrics of both
spectral cells through the harness at a tiny size on the CPU with
--trace 1: each of the five metrics is the window's span a frame, the
spans nest as the program opens them (pool build and head solve inside
the two phase fits, targets and the hard-BC map inside those), and the
check stays correct."""
import pytest

from .conftest import run_tiny, tiny_cell

SPANS = {"pool_build_s": "pool_build", "fit_targets_s": "fit_targets",
         "bc_affine_s": "bc_affine", "head_solve_s": "head_solve",
         "key_draw_s": "key_draw"}


@pytest.mark.parametrize("cell", ["smoke.spectral", "tg.spectral"])
def test_fit_spans_are_read_and_nest(cell):
    result, notes = run_tiny(tiny_cell(cell), trace=1)
    metrics, st = result["metrics"], notes["stage_s"]
    for name, span in SPANS.items():
        assert metrics[name]["unit"] == "s/frame"
        assert metrics[name]["value"] == st[span] > 0.0, name
    fits = st["advect_fit"] + st["project_fit"]
    eager = st["pool_build"] + st["head_solve"]
    assert fits >= eager >= st["fit_targets"] + st["bc_affine"]
    assert result["correct"] is True, result["check"]
