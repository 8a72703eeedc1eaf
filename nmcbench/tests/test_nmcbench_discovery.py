"""A configuration, a traffic mix, a per-layer metric and a cell's limits
dropped into a copy of the benchmark's folder are found by name, with no
other file edited: a copy of a box configuration, and one that is not a
box (fixtures/karman_s0: a channel around a circle), whose own reference
module decides its geometry."""
import json
import os
import shutil

import pytest

from nmcbench import run as R

from .conftest import run_tiny, tiny_cell

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("config,source", [
    ("tg_copy", os.path.join(R.HERE, "configs", "taylorgreen")),
    ("karman_s0", os.path.join(FIXTURES, "karman_s0"))])
def test_dropped_in_files_are_found_by_name(config, source, tmp_path):
    here = tmp_path / "nmcbench"
    shutil.copytree(R.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {os.path.join(d, p): open(os.path.join(d, p), "rb").read()
              for d, _, fs in os.walk(here) for p in fs}
    for ext in (".json", ".py"):
        shutil.copy(source + ext, here / "configs" / (config + ext))
    traffic = json.loads((here / "traffic" / "spectral.json").read_text())
    traffic["frames"] = "a mix added as data"
    (here / "traffic" / "spectral_b.json").write_text(json.dumps(traffic))
    (here / "metrics" / "frames_counted.py").write_text(
        "def read(ctx):\n    return float(ctx.frames)\n")
    name = config + ".spectral_b"
    limits = json.loads((here / "limits" / "tg.spectral.json").read_text())
    (here / "limits" / (name + ".json")).write_text(json.dumps(limits))
    bench = R.load_json(R.ROOT, "BENCHMARK.json")
    bench["configs"].append(dict(bench["configs"][0], name=config,
                                 file=f"nmcbench/configs/{config}.json"))
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": "spectral_b", "chips": 1,
                               "why": "added"})
    bench["per_layer"].append({"name": "frames_counted", "unit": "frames",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "whole frame", "moves": "frame_s",
                               "workloads": [name]})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_s":
            m["workloads"].append(name)
    # a cloud of 16,384 points, some of them within the mask distance of
    # the boundary, where the geometry decides p and grad p
    cell = tiny_cell(name, bench_=bench, here=str(here), wost_resolution=128)
    assert cell.traffic["frames"] == "a mix added as data"
    assert cell.scene_ref.__file__ == str(here / "configs" / (config + ".py"))
    result, notes = run_tiny(cell, trace=1)
    assert result["metrics"]["frames_counted"]["value"] == result["attempted"]
    assert result["correct"] is True, (result["check"], notes["check_notes"])
    assert notes["check_notes"]["valid_mismatch"] == 0
    # the files that were there are unchanged
    for path, data in before.items():
        assert open(path, "rb").read() == data
