"""The port's bench entry (python -m nmcfluid_torch.bench) on the CPU.

At a tiny scale with --device cpu it prints one parseable JSON line with
the metric name of bench.py's contract and writes its detail file where
it is told (by default under the git-ignored chiprun_out/), never to a
tracked file; on an error, and without a card unless the CPU is asked
for, it prints the error line and exits nonzero. The ramp width its frame
steps with after add_source is the scene's own rule.
"""
import hashlib
import json
import pathlib

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
from nmcfluid_torch import bench
from nmcfluid_torch.scenes import get_scene

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tracked_digest():
    """Digest of the tracked files the JAX bench writes or reads."""
    return {name: hashlib.sha256((ROOT / name).read_bytes()).hexdigest()
            for name in ("bench_detail.json", "BASELINE_WALL.json")}


def _run(monkeypatch, capsys, argv, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    try:
        bench.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return code, json.loads(lines[0])


@pytest.mark.parametrize("scene, metric", [
    ("taylorgreen", "taylorgreen2d_sec_per_frame"),
    ("jpipe", "jpipe2d_sec_per_frame"),
    ("smoke", "smoke3d_sec_per_frame")])
def test_bench_on_cpu_prints_one_line(monkeypatch, capsys, tmp_path, scene,
                                      metric):
    """One JSON line with the contract's keys and a positive value, the
    detail (stage breakdown, walk counts) at NMCFLUID_BENCH_DETAIL, no
    tracked file touched."""
    before = _tracked_digest()
    detail = tmp_path / "detail.json"
    code, line = _run(monkeypatch, capsys, ["--device", "cpu"],
                      NMCFLUID_BENCH_SCENE=scene, NMCFLUID_BENCH_SCALE=32,
                      NMCFLUID_BENCH_ITERS=3, NMCFLUID_BENCH_DETAIL=detail)
    assert code == 0
    assert line["metric"] == metric and line["unit"] == "s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["device"] == "cpu"
    d = json.loads(detail.read_text())
    assert set(d["stage_breakdown_s"]) == {"advect_fit", "div_grid",
                                          "wost_solve", "project_fit"}
    assert d["walk"]["steps"] > 0 and d["timed_step_s"] == line["value"]
    assert d["fit_mfu"] is None and d["card"] is None   # no card, no kernel
    assert _tracked_digest() == before


@pytest.mark.parametrize("scene, proj, solve", [
    ("taylorgreen", "bem", "bem_solve"),
    ("smoke", "spectral", "spectral_solve")])
def test_bench_flagship_frame(monkeypatch, capsys, tmp_path, scene, proj,
                              solve):
    """The flagship frame, as bench.py's: bem in 2D, spectral in 3D, its
    timed step and stage breakdown in the detail file, the printed line
    unchanged in form; NMCFLUID_BENCH_FLAGSHIP=0 leaves it out."""
    detail = tmp_path / "detail.json"
    env = dict(NMCFLUID_BENCH_SCENE=scene, NMCFLUID_BENCH_SCALE=32,
               NMCFLUID_BENCH_ITERS=3, NMCFLUID_BENCH_DETAIL=detail)
    code, line = _run(monkeypatch, capsys, ["--device", "cpu"], **env)
    assert code == 0 and set(line) == {"metric", "value", "unit",
                                       "vs_baseline", "device"}
    fl = json.loads(detail.read_text())["flagship"]
    assert fl["projection"] == proj and fl["timed_step_s"] > 0
    assert set(fl["stage_breakdown_s"]) == {"advect_fit", "div_grid", solve,
                                            "project_fit"}
    code, _ = _run(monkeypatch, capsys, ["--device", "cpu"],
                   NMCFLUID_BENCH_FLAGSHIP=0, **env)
    assert code == 0 and json.loads(detail.read_text())["flagship"] is None


def test_bench_default_detail_path_is_ignored_by_git(monkeypatch):
    """The default detail file lies under chiprun_out/, which .gitignore
    lists, so a run on a checkout leaves git's tree as it was."""
    monkeypatch.delenv("NMCFLUID_BENCH_DETAIL", raising=False)
    rel = pathlib.Path(bench.detail_path("smoke")).relative_to(ROOT)
    assert rel.parts == ("chiprun_out", "bench_smoke.json")
    assert "chiprun_out/" in (ROOT / ".gitignore").read_text().split()


def test_bench_error_line_and_exit_code(monkeypatch, capsys):
    """An unknown scene: one line with a null value and the error, exit
    code 1."""
    code, line = _run(monkeypatch, capsys, ["--device", "cpu"],
                      NMCFLUID_BENCH_SCENE="nope")
    assert code == 1
    assert line["value"] is None and "nope" in line["error"]
    assert line["metric"] == "nope_sec_per_frame"


def test_bench_needs_a_card_unless_asked_for_cpu(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code, line = _run(monkeypatch, capsys, [],
                      NMCFLUID_BENCH_SCENE="smoke")
    assert code == 1 and line["value"] is None
    assert line["metric"] == "smoke3d_sec_per_frame"
    assert 'device="cpu"' in line["error"]


@pytest.mark.parametrize("name", ["taylorgreen", "karman", "karman2cyl",
                                  "karman3cyl", "jpipe", "smoke",
                                  "smoke_obs", "vortex_collide", "karman3d"])
def test_ramp_width_after_source(name):
    """The ramp width the steps use after add_source: halved in the 2D
    karman family as the JAX CLI does (nmcfluid/run.py:498-500), kept in
    Taylor-Green, jpipe and every 3D scene (karman3d too)."""
    scene = get_scene(name)
    halved = name in ("karman", "karman2cyl", "karman3cyl")
    eps = torch.tensor(scene.bdry_eps)
    assert float(scene.eps_after_source(eps)) == float(
        eps / 2 if halved else eps)
