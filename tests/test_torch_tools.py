"""The analysis tools of the port (nmcfluid_torch/tools_*.py) against the
JAX package's, on the CPU at small sizes.

Held, each at the tolerance stated in its test: street_metrics on
tests/test_compare_street.py's synthetic signals (equal: the same numpy
code); the probe series of both street tools on the same checkpoint files
(2D vorticity at rtol 1e-4 with an atol of 1e-5 of its magnitude, 3D
velocity at rtol 1e-5 / atol 1e-6); the volume compositing and the
rendered pngs (equal); one tiny oracle-floor frame under the JAX-replay
key (rtol 1e-4); the cross-solver gap of collect_2cyl (rtol 1e-5) and the
plot_scalar frames (equal). The sigma ablation runs tiny on the CPU. Each
tool that draws refuses at parsing where matplotlib is missing, and each
that computes runs on the card unless given --device cpu.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest

from _torch_parity import JaxKey, params_np

import nmcfluid.sim.fluid as jfluid
import nmcfluid.tools_compare_street as jcs
import nmcfluid.tools_render_density3d as jrender
import nmcfluid.tools_street3d as js3d
import nmcfluid.transport.density as jdensity
import nmcfluid_torch.sim.fluid as tfluid
import nmcfluid_torch.tools_ablation_sigma as tabl
import nmcfluid_torch.tools_collect_2cyl as t2cyl
import nmcfluid_torch.tools_compare_street as tcs
import nmcfluid_torch.tools_oracle_floor as toracle
import nmcfluid_torch.tools_plot_scalar as tplot
import nmcfluid_torch.tools_render_density3d as trender
import nmcfluid_torch.tools_street3d as ts3d
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.utils.checkpoint import save_ckpt as j_save_ckpt
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.utils.checkpoint import save_ckpt as t_save_ckpt

SMALL = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
             fit_pool=4)


def _signals():
    """tests/test_compare_street.py's four synthetic probe signals."""
    t = np.arange(200) * 0.05
    env = np.clip((t - 5.0) / 1.0, 0.0, 1.0)
    yield env * np.sin(2 * np.pi * 0.9 * t)
    bump = -5.0 * np.exp(-0.5 * ((t - 1.5) / 0.3) ** 2)
    offset = 1.7 / (1.0 + np.exp(-(t - 2.5)))
    env = np.clip((t - 5.8) / 0.8, 0.0, 1.0) * 8.0
    yield bump + offset + env * np.sin(2 * np.pi * 1.0 * t)
    ring = (np.exp(-0.5 * ((t - 0.3) / 0.25) ** 2)
            * np.sin(2 * np.pi * 2.2 * t))
    env = np.clip((t - 5.5) / 1.5, 0.0, 1.0) * 1.5
    yield (ring + 0.15 * np.sin(2 * np.pi * 0.6 * t) * (t > 2.0)
           + env * np.sin(2 * np.pi * 0.6 * t))
    yield 1e-6 * np.random.default_rng(0).normal(size=100)


@pytest.mark.parametrize("i", range(4))
def test_street_metrics_match_jax(i):
    w = list(_signals())[i]
    assert tcs.street_metrics(w, 0.05, 0.089, 0.5) == jcs.street_metrics(
        w, 0.05, 0.089, 0.5)


def _jax_run_dir(root, scene, n_steps):
    """Checkpoints 0..n_steps of the JAX package's fluid, seed t at step t
    (so the frames differ)."""
    fluid = jfluid.NeuralFluid(j_get_scene(scene), max_n_iters=1)
    for t in range(n_steps + 1):
        j_save_ckpt(os.path.join(root, "model"),
                    fluid.init_state(t).params, t)
    return str(root)


def test_probe_series_matches_jax(tmp_path, monkeypatch):
    """2D probe vorticity on the same checkpoint files: rtol 1e-4, atol
    1e-5 of the largest magnitude."""
    monkeypatch.setattr(tcs, "Key", JaxKey)
    exp = _jax_run_dir(tmp_path, "karman", 3)
    probes = [(0.2, 0.0), (0.5, 0.1), (-0.3, -0.2)]
    want = jcs.probe_series(exp, j_get_scene("karman"), probes)
    got = tcs.probe_series(exp, t_get_scene("karman"), probes,
                           device="cpu")
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_probe_series_vel_matches_jax(tmp_path, monkeypatch):
    """3D probe velocity on the same checkpoint files: rtol 1e-5, atol
    1e-6."""
    monkeypatch.setattr(tcs, "Key", JaxKey)
    exp = _jax_run_dir(tmp_path, "karman3d", 3)
    probes = [(0.0, 0.0, -0.2), (0.1, 0.0, -0.2)]
    want = js3d.probe_series_vel(exp, j_get_scene("karman3d"), probes,
                                 comp=0)
    got = ts3d.probe_series_vel(exp, t_get_scene("karman3d"), probes,
                                comp=0, device="cpu")
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_street3d_cli_writes_metrics_and_png(tmp_path, capsys):
    """The port's CLI on the port's own checkpoints (constant weights: no
    street, and the metrics say so)."""
    fluid = tfluid.NeuralFluid(t_get_scene("karman3d"), max_n_iters=1,
                               device="cpu")
    params = fluid.init_state(0).params
    for t in range(7):
        t_save_ckpt(str(tmp_path / "model"), params, t)
    out_png = str(tmp_path / "street.png")
    ts3d.main([str(tmp_path), "--out", out_png, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    m = json.loads(next(line for line in lines if line.startswith("{")))
    assert m["strouhal"] is None
    assert os.path.exists(out_png)


@pytest.mark.parametrize("module", [tcs, ts3d])
def test_street_png_refused_without_matplotlib(module, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(tcs, "have_matplotlib", lambda: False)
    args = [str(tmp_path)] * (2 if module is tcs else 1)
    with pytest.raises(SystemExit) as e:
        module.main(args + ["--out", str(tmp_path / "x.png"),
                            "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_composite_matches_jax(axis):
    rng = np.random.default_rng(axis)
    rho = rng.uniform(0, 0.5, (8, 9, 10)).astype(np.float32)
    col = rng.uniform(0, 1, (8, 9, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        trender.composite(rho, col, axis=axis, bg=0.7),
        jrender.composite(rho, col, axis=axis, bg=0.7))


def test_render_cli_matches_jax(tmp_path):
    """Both CLIs on the same density frames (one gray, one with Cd
    colors): the same pngs, and the gif of the port's frames."""
    import matplotlib.pyplot as plt
    from PIL import Image
    rng = np.random.default_rng(3)
    for root in ("jax", "torch"):
        (tmp_path / root / "density").mkdir(parents=True)
    for t in (0, 1):
        rho = rng.uniform(0, 2, (8, 8, 8)).astype(np.float32)
        kw = {"Cd": rng.uniform(0, 1, (8, 8, 8, 3)).astype(np.float32)} \
            if t else {}
        for root in ("jax", "torch"):
            np.savez_compressed(tmp_path / root / "density" /
                                f"density_t{t:03d}.npz", density=rho, **kw)
    args = ["--frames", "0", "1", "--deficit"]
    jrender.main([str(tmp_path / "jax")] + args)
    trender.main([str(tmp_path / "torch")] + args + [
        "--gif", str(tmp_path / "a.gif")])
    for t in (0, 1):
        name = f"render/density_t{t:03d}.png"
        np.testing.assert_array_equal(plt.imread(tmp_path / "torch" / name),
                                      plt.imread(tmp_path / "jax" / name))
    with Image.open(tmp_path / "a.gif") as im:
        assert im.n_frames == 2


def test_oracle_floor_matches_jax():
    """One frame (add_source, then two source fits on key.split()) under
    the JAX-replay key, both packages on the fresh-batch fit of a 2 x 32
    TG net (150 iterations, no head solve: the JAX package compiles less):
    the TG error of the raw 32^2 grid at rtol 1e-4."""
    import dataclasses
    sizes = dict(SMALL, max_n_iters=150, fit_mode="xla", ls_head=0)
    sizes.pop("fit_pool")
    net = dict(num_hidden_layers=2, hidden_features=32)
    jf = jfluid.NeuralFluid(dataclasses.replace(
        j_get_scene("taylorgreen"), **net), **sizes)
    js = jf.add_source(jf.init_state(0))
    params, key = js.params, js.key
    for _ in range(2):
        key, kf = jax.random.split(key)
        params, _ = jfluid._fit_source(jf, params, kf, js.eps, js.timestep)
    want = jdensity.tg_velocity_error(jdensity.raw_velocity_grid(jf, params,
                                                                 32))
    tf = tfluid.NeuralFluid(dataclasses.replace(
        t_get_scene("taylorgreen"), **net), device="cpu", **sizes)
    ts = tf.add_source(tf.init_state(key=JaxKey.from_seed(0)))
    for a, b in zip(params_np(ts.params), params_np(js.params)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
    (frame, got), = toracle.oracle_floor(tf, ts, 1, 2, 32)
    assert frame == 1
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_oracle_floor_cli(tmp_path, monkeypatch, capsys):
    """The CLI on the fit kernel's plain twin at tiny sizes: a finite
    curve, its file and the summary line; without --device it needs the
    card and writes nothing."""
    out = tmp_path / "floor.txt"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toracle.main(["--out", str(out)])
    assert not out.exists()
    monkeypatch.setattr(toracle, "NeuralFluid", lambda scene, **kw:
                        tfluid.NeuralFluid(scene, **SMALL, **kw))
    toracle.main(["--frames", "2", "--max_n_iters", "5", "--grid", "16",
                  "--out", str(out), "--device", "cpu"])
    curve = np.loadtxt(out)
    assert curve.shape == (2,) and np.all(np.isfinite(curve))
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["device"] == "cpu" and rep["frames"] == 2


def test_ablation_sigma_tiny(tmp_path, monkeypatch, capsys):
    """One sigma on a 8-high karman grid at 4 walks: the png and a finite
    pressure range."""
    real = tfluid.NeuralFluid
    monkeypatch.setattr(tfluid, "NeuralFluid", lambda scene, **kw:
                        real(scene, **SMALL, **kw))
    tabl.main(["--sigmas", "350", "--res", "8", "--n_walks", "4",
               "--max_n_iters", "5", "--chunk", "64", "--out",
               str(tmp_path), "--device", "cpu"])
    assert (tmp_path / "sigma_350.png").exists()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    lo, hi = (float(v) for v in line.split("[")[1].split("]")[0].split(","))
    assert np.isfinite(lo) and np.isfinite(hi) and lo <= hi


def test_collect_2cyl_matches_jax(tmp_path, monkeypatch):
    """The cross-solver gap and energy curves of two fake karman2cyl runs
    (three checkpoints each, the port's weights), both packages on the
    same files: rtol 1e-5."""
    import nmcfluid.tools_collect_2cyl as j2cyl
    monkeypatch.setattr(t2cyl, "Key", JaxKey)
    fl = tfluid.NeuralFluid(t_get_scene("karman2cyl"), max_n_iters=1,
                            device="cpu")
    for run, seed in (("wost", 0), ("bem", 1)):
        for t in range(4):
            t_save_ckpt(str(tmp_path / run / "model"),
                        fl.init_state(seed + t).params, t)
    runs = ["--wost", str(tmp_path / "wost"), "--bem", str(tmp_path / "bem")]
    monkeypatch.setattr(sys, "argv", ["collect"] + runs + [
        "--out", str(tmp_path / "jax")])
    j2cyl.main()
    t2cyl.main(runs + ["--out", str(tmp_path / "torch"), "--device", "cpu"])
    rep = {r: json.loads((tmp_path / r / "cross_solver_gap.json"
                          ).read_text()) for r in ("jax", "torch")}
    assert rep["torch"]["frames_compared"] == 3
    np.testing.assert_allclose(rep["torch"]["rel_velocity_gap_per_frame"],
                               rep["jax"]["rel_velocity_gap_per_frame"],
                               rtol=1e-5)
    for run in ("wost", "bem"):
        np.testing.assert_allclose(
            np.loadtxt(tmp_path / "torch" / f"energy_{run}.txt"),
            np.loadtxt(tmp_path / "jax" / f"energy_{run}.txt"), rtol=1e-5)


def test_plot_scalar_matches_jax(tmp_path):
    import matplotlib.pyplot as plt
    import nmcfluid.tools_plot_scalar as jplot
    rng = np.random.default_rng(0)
    for root in ("jax", "torch"):
        (tmp_path / root / "txt").mkdir(parents=True)
    for t in range(2):
        w = rng.normal(0, 2, (8, 8))
        for root in ("jax", "torch"):
            np.savetxt(tmp_path / root / "txt" /
                       f"vorticity_values_t{t:03d}.txt", w.reshape(-1))
    jplot.main([str(tmp_path / "jax" / "txt"), "8"])
    tplot.main([str(tmp_path / "torch" / "txt"), "8"])
    for t in range(2):
        name = f"vorticity_clean/vorticity_clean_t{t:03d}.png"
        np.testing.assert_array_equal(plt.imread(tmp_path / "torch" / name),
                                      plt.imread(tmp_path / "jax" / name))


def test_device_defaults_to_the_card(tmp_path):
    """The tools that compute take --device, default the card: here they
    raise before writing anything."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.main([str(tmp_path), str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t2cyl.main(["--wost", "a", "--bem", "b", "--out",
                    str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def _numbers(tree):
    """The leaves of a nested dict/list of JSON values."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _numbers(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _numbers(v)]
    return [tree]


@pytest.mark.parametrize("tool", ["walk_roofline", "fit_microbench"])
def test_card_tools_refuse_without_a_card_and_rehearse(tool, tmp_path):
    """tools_walk_roofline and tools_fit_microbench measure the card: by
    default they refuse without one, before writing; with --device cpu
    they run every item at a tiny size with host times only, every
    device number and the card "not measured", and write one JSON."""
    import nmcfluid_torch.tools_fit_microbench as tmicro
    import nmcfluid_torch.tools_walk_roofline as troof
    out = tmp_path / "out.json"
    if tool == "walk_roofline":
        main = troof.main
        cpu = ["--device", "cpu", "--points", "256", "--n_walks", "16"]
        items = ("pool_width", "advance_parts")
    else:
        main = tmicro.main
        cpu = ["--device", "cpu", "--quick", "--n_batch", "256"]
        items = ("ms_per_iter",)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(["--out", str(out)])
    assert not out.exists()
    res = main(cpu + ["--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert res["card"] == troof.NOT_MEASURED
    for item in items:
        for name, row in res[item].items():
            assert np.isfinite(row["host_ms"]) and row["host_ms"] > 0, name
            assert row.get("device_ms", troof.NOT_MEASURED) \
                == troof.NOT_MEASURED, name
    if tool == "walk_roofline":
        assert set(res["ceilings"].values()) == {troof.NOT_MEASURED}
        for algo in ("pool", "gen"):
            e2e = res["end_to_end"][algo]
            assert e2e["device_busy_s"] == troof.NOT_MEASURED
            assert e2e["counts"]["steps"] > 0 and e2e["wall_s"] > 0
            assert "device_idle_share" not in e2e
    else:
        assert res["ms_per_iter"]["adam_fit_single"]["executor"] \
            == "fresh-batch"
        assert res["ms_per_iter"]["fit_kernel"]["executor"] == "plain twin"
    assert all(isinstance(x, (int, float, str, bool)) or x is None
               for x in _numbers(res))
