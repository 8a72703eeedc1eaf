"""Every cell of BENCHMARK.json, and the walk cell that waits for a bound,
through the harness at a tiny size on the CPU: the result line has the
contract's keys (and the check last), the metrics are the cell's, and a
sound run is correct."""
import json

import pytest

from nmcbench import run as R

from .conftest import bench, run_tiny, tiny_cell

BENCH = bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(result, notes, capsys):
    R.report(result, notes)
    out = capsys.readouterr()
    last = out.out.strip().splitlines()[-1]
    assert out.err.strip().splitlines()[-1].startswith("check correct:")
    return json.loads(last)


def _expected(kind, cell):
    return {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end_line(cell, capsys):
    result, notes = run_tiny(tiny_cell(cell))
    # one frame recorded, drawn among the first two, and run if the
    # window ended before it
    assert 1 <= notes["checked_frame"] <= 2
    assert notes["checked_frame"] <= result["attempted"] \
        + notes["frames_past_window"]
    line = _line(result, notes, capsys)
    assert list(line) == KEYS + ["check"]
    assert set(line["metrics"]) == _expected("end_to_end", cell)
    assert line["correct"] is True, line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for row in line["check"].values():
        assert set(row) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced_line(cell, capsys):
    result, notes = run_tiny(tiny_cell(cell), trace=1)
    line = _line(result, notes, capsys)
    assert list(line) == KEYS + ["breakdown", "check"]
    # off the card the profiler sees no device: the trace's metrics are
    # left out, never written as 0
    want = _expected("per_layer", cell) - {"idle_share.frame",
                                           "idle_share.mc", "fit_roofline",
                                           "fit_eager_s"}
    assert set(line["metrics"]) == want
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True, line["check"]


def test_every_metric_and_cell_has_its_files():
    for w in BENCH["workloads"]:
        cell = R.Cell(w["name"], bench=BENCH)
        assert cell.limits["check_frames"] >= 1
        assert set(cell.limits["numbers"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            R.Cell(CELLS[0], bench=BENCH).metrics(kind)
            assert hasattr(R.load_module(
                f"{R.HERE}/metrics/{m['name']}.py", "m"), "read")
