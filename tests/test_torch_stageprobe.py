"""The stage probe of a Taylor-Green step (nmcfluid_torch/sim/stageprobe.py)
and its JAX counterpart (port_stages.py), on the CPU at tiny sizes.

The probe's --frames mode runs the stepper as the command line runs it,
so from the CLI's checkpoint after add_source it gives the CLI's error
rows bit for bit; its one-step readings and port_stages.py's come out
under the same keys; and the committed checkpoints they start from load
in both packages.
"""
import json
import subprocess
import sys

import numpy as np
import torch

from _torch_parity import mc_below

import nmcfluid_torch.run as trun
from nmcfluid_torch.sim import stageprobe
from nmcfluid_torch.utils.checkpoint import load_ckpt
from nmcfluid_torch.utils.keys import Key

# the sizes of stageprobe --small
TINY = ["--max_n_iters", "50", "--sample_resolution", "16",
        "--wost_resolution", "32", "--div_resolution", "64",
        "--n_walks", "48", "--fit_pool", "8"]
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def test_curve_stats():
    """Growth is the least-squares slope over rows 1.. (row 0, the state
    after add_source, left out) and mean the mean of those rows."""
    rows = [9.0] + [2.0 + 0.5 * k for k in range(1, 11)]
    got = stageprobe.curve_stats(rows)
    assert got["rows"] == 10
    np.testing.assert_allclose(got["growth"], 0.5, rtol=1e-12)
    np.testing.assert_allclose(got["mean"], np.mean(rows[1:]), rtol=1e-12)
    np.testing.assert_allclose(stageprobe.curve_stats(rows, 2)["growth"],
                               0.5, rtol=1e-12)


def test_frames_reproduce_the_cli(tmp_path):
    """--frames from the CLI's checkpoint after add_source, with the CLI's
    seed, steps exactly as the CLI does: the same TG error rows, bit for
    bit (the small configuration of --small, the CLI on the same
    flags)."""
    trun.main(["taylorgreen", "--device", "cpu", "--seed", "3",
               "--n_timesteps", "2", "--density", "--density_resolution",
               "1000", "--out", str(tmp_path)] + TINY)
    want = np.loadtxt(tmp_path / "taylorgreen" / "error_ours.txt")
    res = stageprobe.main(["--device", "cpu", "--small", "--ckpt",
                           str(tmp_path / "taylorgreen" / "model"),
                           "--step", "0", "--frames", "2", "--seed", "3",
                           "--curve_out", str(tmp_path / "curve.txt")])
    np.testing.assert_array_equal(res["rows_all"], want)
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "curve.txt"), want)


def test_committed_checkpoints_load():
    """The committed checkpoints (the port's seed 1 after step 10, the JAX
    package's seed-0, 1 and 2 add_source) load as TG's 6 x 64 net,
    finite."""
    fluid = stageprobe.make_fluid("cpu", small=True)
    like = fluid.init_state(0).params
    for d, step in (("docs/tg_stage_ckpt", 10), ("docs/tg_jax_seed0", 0),
                    ("docs/tg_jax_seed1", 0), ("docs/tg_jax_seed2", 0)):
        params, t = load_ckpt(str(ROOT / d), like, step)
        assert t == step
        for (W, b), (W0, b0) in zip(params, like):
            assert W.shape == W0.shape and b.shape == b0.shape
            assert bool(torch.isfinite(W).all())


def test_probe_and_port_stages_print_the_same_readings(tmp_path):
    """One light probe step of the port and port_stages.py's JAX step, both
    --small from the same checkpoint: the same reading keys, the same
    error before the step, and an advection fit that leaves the error
    where the JAX package's leaves it (rtol 1e-2: each package draws its
    own keys)."""
    trun.main(["taylorgreen", "--device", "cpu", "--n_timesteps", "1",
               "--out", str(tmp_path)] + TINY)
    model = tmp_path / "taylorgreen" / "model"
    fluid = stageprobe.make_fluid("cpu", small=True)
    params, t = load_ckpt(str(model), fluid.init_state(0).params, 1)
    port, _ = stageprobe.probe_step(fluid, params, t, Key(0), light=True)
    out = subprocess.run(
        [sys.executable, str(ROOT / "port_stages.py"), "--small", "--ckpt",
         str(model), "--step", "1", "--keys", "0"], capture_output=True,
        text=True, check=True,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)}, cwd=str(tmp_path))
    jax = json.loads(out.stdout.strip().splitlines()[-1])
    for k in ("tg_err", "loss", "div_rms", "project_one_chunk"):
        assert set(port[k]) <= set(jax[k]) | {"after_project", "project"}
    np.testing.assert_allclose(port["tg_err"]["before"],
                               jax["tg_err"]["before"], rtol=1e-5)
    after, want = port["tg_err"]["after_advect"], jax["tg_err"]["after_advect"]
    mc_below(abs(after - want), 1e-2 * abs(want),
             "the advection fit's error against JAX's, over rtol 1e-2")
    assert np.isfinite(port["project_one_chunk"]["tg_err"])


def test_frames_take_the_projection(tmp_path, monkeypatch):
    """--frames --projection steps under the deterministic projections;
    the same start under each gives its own curve, row 0 the same (the TG
    error read on a 64^2 grid here, to keep the test short)."""
    raw = stageprobe.raw_velocity_grid
    monkeypatch.setattr(stageprobe, "raw_velocity_grid",
                        lambda fluid, params, n: raw(fluid, params, 64))
    rows = {}
    for proj in ("spectral", "bem"):
        res = stageprobe.main(["--device", "cpu", "--small", "--ckpt",
                               str(ROOT / "docs/tg_jax_seed1"), "--step",
                               "0", "--frames", "1", "--seed", "1",
                               "--projection", proj])
        assert res["projection"] == proj and len(res["rows_all"]) == 2
        assert np.all(np.isfinite(res["rows_all"]))
        rows[proj] = res["rows_all"]
    assert rows["spectral"][0] == rows["bem"][0]
    assert rows["spectral"][1] != rows["bem"][1]


def _jax_env(tmp_path):
    return {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
            "HOME": str(tmp_path)}


def test_port_stages_source_seed_writes_a_start(tmp_path):
    """port_stages.py --source_seed writes the JAX package's add_source as
    a checkpoint of the step it is (0) and prints its TG error, the same
    on a rerun (the JAX package's fit is deterministic for its seed)."""
    errs = []
    for run in ("a", "b"):
        out = subprocess.run(
            [sys.executable, str(ROOT / "port_stages.py"), "--small",
             "--source_seed", "2", "--save", str(tmp_path / run)],
            capture_output=True, text=True, check=True,
            env=_jax_env(tmp_path), cwd=str(tmp_path))
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["seed"] == 2 and np.isfinite(line["tg_err"])
        errs.append(line["tg_err"])
    fluid = stageprobe.make_fluid("cpu", small=True)
    a, t = load_ckpt(str(tmp_path / "a"), fluid.init_state(0).params, 0)
    b, _ = load_ckpt(str(tmp_path / "b"), fluid.init_state(0).params, 0)
    assert t == 0 and errs[0] == errs[1]
    for (Wa, ba), (Wb, bb) in zip(a, b):
        assert torch.equal(Wa, Wb) and torch.equal(ba, bb)


def test_source_split_agrees_on_the_same_draws(tmp_path):
    """tests/source_split.py --small: on the same draws the two packages'
    fused source fits (the JAX package's XLA mirror, the port's twin)
    leave the same TG error after Adam and after the head solve (rtol
    1e-4; measured 3e-9 relative) and parameters within the fit tolerance
    of tests/test_torch_step.py (atol 1e-3; measured 3.8e-6), and write
    both states."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "source_split.py"), "--small",
         "--seed", "1", "--out", str(tmp_path)], capture_output=True,
        text=True, check=True, env=_jax_env(tmp_path), cwd=str(tmp_path))
    line = json.loads(out.stdout.strip().splitlines()[-1])
    j, p = line["tg_err"]["jax"], line["tg_err"]["port"]
    for k in ("after_adam", "after_head", "loss"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4)
    assert line["max_param_diff"] < 1e-3
    for who in ("jax_fused", "port_fused"):
        assert (tmp_path / who / "ckpt_step_t000.npz").exists()
