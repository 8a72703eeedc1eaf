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
    """The Part A checkpoints (the port's seed 1 after step 10, the JAX
    package's seed-0 add_source) load as TG's 6 x 64 net, finite."""
    fluid = stageprobe.make_fluid("cpu", small=True)
    like = fluid.init_state(0).params
    for d, step in (("docs/tg_stage_ckpt", 10), ("docs/tg_jax_seed0", 0)):
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
    np.testing.assert_allclose(port["tg_err"]["after_advect"],
                               jax["tg_err"]["after_advect"], rtol=1e-2)
    assert np.isfinite(port["project_one_chunk"]["tg_err"])
