"""The port's command line (nmcfluid_torch/run.py, replay.py) end to end
against the JAX package's (nmcfluid/run.py, replay.py), on the CPU, at
tiny sizes: Taylor-Green and karman here, smoke (3D, --adv_ref) in
tests/test_torch_run3d.py.

Both CLIs run in this process on the same arguments with the fresh-batch
fit (--fit_mode xla), the port with --device cpu and its key seam
(run.Key, replay.Key) replaced by the JAX-replay key, so both draw the
same random numbers (tests/_torch_parity.py::cli_pair). One run of each
CLI per scene serves several tests: Taylor-Green with --draw --density
--vis_frequency, karman plain.

Tolerances are the chained-step ones of the step tests: Taylor-Green
rtol 2e-4 / atol 1e-3 (tests/test_torch_step.py), karman's trunk rtol
2e-4 / atol 2e-6 with its head's W at atol 3e-5
(tests/test_torch_karman.py); derived files at the tolerances stated
where they are read.
"""
import json
import shutil

import numpy as np
import pytest

from _torch_parity import (CLI_TINY, assert_ckpts_match, assert_same_files,
                           capture_frames, cli_pair, replay_key_seam)

import nmcfluid.replay as jreplay
import nmcfluid.utils.vis as jvis
import nmcfluid_torch.replay as treplay
import nmcfluid_torch.run as trun
import nmcfluid_torch.utils.vis as tvis

RUNS = {"taylorgreen": ["--draw", "--density", "--vis_frequency", "5"],
        "karman": []}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Lazily, per scene: cli_pair on RUNS[scene]."""
    done = {}

    def get(scene):
        if scene not in done:
            done[scene] = cli_pair(tmp_path_factory.mktemp(scene), scene,
                                   RUNS[scene])
        return done[scene]
    return get


@pytest.mark.parametrize("scene", sorted(RUNS))
def test_checkpoints_match_jax(cli_runs, scene):
    """(a) The checkpoints of the two CLIs agree."""
    jdir, tdir, _ = cli_runs(scene)
    if scene == "karman":
        # trunk, then the head's W and b: [W0, b0, W1, b1, W2, b2, Wh, bh]
        atols = [2e-6] * 6 + [3e-5, 2e-6]
    else:
        atols = [1e-3]
    assert_ckpts_match(jdir, tdir, atols)


def test_same_files_under_draw_density_vis_frequency(cli_runs):
    """(b) Taylor-Green under --draw --density --vis_frequency."""
    jdir, tdir, _ = cli_runs("taylorgreen")
    assert_same_files(jdir, tdir)


def test_density_only_on_jax_checkpoints(cli_runs, tmp_path):
    """(c) --density_only over the JAX CLI's checkpoints reproduces the
    density frames it drew and its error_ours.txt, at the rollout
    tolerance rtol 1e-5 / atol 1e-6 (tests/test_torch_transport.py)."""
    jdir, _, frames = cli_runs("taylorgreen")
    shutil.copytree(jdir / "model", tmp_path / "taylorgreen" / "model")
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        capture_frames(mp, tvis, got)
        replay_key_seam(mp)
        trun.main(["taylorgreen", "--density_only", "--out", str(tmp_path),
                   "--device", "cpu"] + CLI_TINY)
    names = sorted(k for k in frames["jax"] if k.startswith("density"))
    assert names == ["density_t000.png", "density_t001.png"]
    assert sorted(got) == names
    for k in names:
        np.testing.assert_allclose(got[k], frames["jax"][k], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "taylorgreen" / "error_ours.txt"),
        np.loadtxt(jdir / "error_ours.txt"), rtol=1e-5)


def test_resume_keeps_energy_rows_and_stops_at_until(tmp_path):
    """(d) --ckpt N keeps energy.txt's first N rows, and --until M stops
    at absolute step M whatever --n_timesteps says."""
    args = ["smoke", "--out", str(tmp_path), "--device", "cpu",
            "--max_n_iters", "10", "--sample_resolution", "8",
            "--wost_resolution", "8", "--div_resolution", "8",
            "--n_walks", "8", "--vel_vis_resolution", "8", "--fit_pool", "4"]
    exp = tmp_path / "smoke"
    trun.main(args + ["--n_timesteps", "2"])
    first = np.loadtxt(exp / "energy.txt")
    assert first.shape == (2,)
    trun.main(args + ["--ckpt", "1", "--until", "3", "--n_timesteps", "9"])
    second = np.loadtxt(exp / "energy.txt")
    assert second.shape == (3,) and second[0] == first[0]
    assert np.all(np.isfinite(second))
    steps = sorted(p.name for p in (exp / "model").iterdir())
    assert steps == [f"ckpt_step_t{t:03d}.npz" for t in range(4)]


@pytest.mark.parametrize("argv,name", [
    pytest.param(["taylorgreen", "--projection", "bvc", "--walk_algo",
                  "lockstep"], "lockstep", id="argv0-projection"),
    pytest.param(["taylorgreen", "--mesh", "2", "--fit_ensemble", "2"],
                 "fit_ensemble", id="argv1-mesh"),
    pytest.param(["taylorgreen", "--wost_source", "net", "--walk_algo",
                  "lockstep"], "lockstep", id="argv2-wost_source"),
    pytest.param(["taylorgreen", "--walk_algo", "pool", "--adaptive_walks",
                  "1"], "adaptive_walks", id="argv3-pool"),
    (["taylorgreen", "--fit_ensemble", "2"], "fit_ensemble"),
    (["taylorgreen", "--walk_algo", "lockstep"], "lockstep"),
    pytest.param(["smoke", "--adaptive_walks", "1"], "adaptive_walks",
                 id="argv6-Yukawa"),
])
def test_once_refused_flags_run_the_cli(tmp_path, monkeypatch, argv,
                                        name):
    """(f) The flags once refused (the lockstep gradient, adaptive
    allocation, fit_ensemble) run the port's CLI at CLI_TINY's sizes,
    alone and beside the flags whose ids these cases keep (--projection
    bvc, --mesh, --wost_source net, --walk_algo pool, smoke's 3D walk):
    the flags reach the NeuralFluid, two checkpoints are written, finite,
    and the config holds each flag (`name` names the setting once
    refused)."""
    made = []
    make = trun.make_fluid

    def capture(args):
        made.append(make(args))
        return made[-1]
    monkeypatch.setattr(trun, "make_fluid", capture)
    out = tmp_path / "out"
    trun.main(argv + CLI_TINY + ["--out", str(out), "--device", "cpu"])
    fluid, = made
    flags = dict(zip(argv[1::2], argv[2::2]))
    assert fluid.walk_settings.algo == flags.get("--walk_algo", "gen")
    assert fluid.walk_settings.adaptive_walks == float(
        flags.get("--adaptive_walks", 0))
    assert fluid.fit_ensemble == int(flags.get("--fit_ensemble", 1))
    exp = out / argv[0]
    steps = sorted(p.name for p in (exp / "model").iterdir())
    assert steps == ["ckpt_step_t000.npz", "ckpt_step_t001.npz"]
    with np.load(exp / "model" / steps[-1]) as z:
        assert all(np.all(np.isfinite(z[k])) for k in z.files
                   if k.startswith("leaf_"))
    cfg = json.loads((exp / "config.json").read_text())
    assert f"--{name}" in flags or name in flags.values()
    for flag, value in flags.items():
        got = cfg[flag[2:]]
        assert str(got) == value or (not isinstance(got, str)
                                     and got == float(value)), (flag, got)


@pytest.mark.parametrize("extra", [["--projection", "bvc"],
                                   ["--walk_algo", "pool"],
                                   ["--projection", "bvc", "--walk_algo",
                                    "pool"],
                                   ["--absorption", "0", "--n_walks", "8"]])
def test_walk_flags_run(tmp_path, extra):
    """--projection bvc, --walk_algo pool (under wost and bvc) and
    --absorption 0 (the harmonic walk) run the port's CLI at CLI_TINY's
    sizes: two checkpoints, finite, and the config names the flags. At
    sigma 0 in the closed box no walk ends (the harmonic throughput never
    meets the roulette) and every one is dropped at the step cap, as in
    the JAX package; 8 walks keep that to one generation."""
    out = tmp_path / "out"
    trun.main(["taylorgreen"] + CLI_TINY + extra
              + ["--out", str(out), "--device", "cpu"])
    exp = out / "taylorgreen"
    steps = sorted(p.name for p in (exp / "model").iterdir())
    assert steps == ["ckpt_step_t000.npz", "ckpt_step_t001.npz"]
    with np.load(exp / "model" / steps[-1]) as z:
        assert all(np.all(np.isfinite(z[k])) for k in z.files
                   if k.startswith("leaf_"))
    cfg = json.loads((exp / "config.json").read_text())
    for flag, value in zip(extra[0::2], extra[1::2]):
        got = cfg[flag[2:]]
        assert str(got) == value or (not isinstance(got, str)
                                     and got == float(value)), (flag, got)


@pytest.mark.parametrize("projection", ["spectral", "bem"])
def test_projection_checkpoints_match_jax(tmp_path, projection):
    """--projection spectral and bem: the two CLIs' Taylor-Green
    checkpoints after add_source and one step agree at the chained-step
    tolerance (rtol 2e-4 / atol 1e-3), and the config names the
    projection."""
    jdir, tdir, _ = cli_pair(tmp_path, "taylorgreen",
                             ["--projection", projection])
    assert_ckpts_match(jdir, tdir, [1e-3])
    cfg = json.loads((tdir / "config.json").read_text())
    assert cfg["projection"] == projection


@pytest.mark.parametrize("scene", ["jpipe", "karman2cyl"])
def test_spectral_refused_before_any_file(tmp_path, scene):
    """Where the JAX CLI refuses --projection spectral (the obstacle is
    not one circle) the port raises the same ValueError before any
    file."""
    out = tmp_path / "out"
    with pytest.raises(ValueError, match="spectral is unsupported"):
        trun.main([scene, "--projection", "spectral", "--out", str(out),
                   "--device", "cpu"])
    assert not out.exists()


def test_replay_matches_jax(cli_runs, tmp_path):
    """(g) replay energy (both formats) and replay vorticity on the JAX
    CLI's Taylor-Green checkpoints, in both packages: energies at the
    rollout rtol 1e-5, vorticity at the derivatives' rtol 1e-4 / atol
    5e-5 (tests/test_torch_transport.py)."""
    exp = tmp_path / "taylorgreen"
    shutil.copytree(cli_runs("taylorgreen")[0] / "model", exp / "model")
    frames = {"jax": {}, "torch": {}}
    with pytest.MonkeyPatch.context() as mp:
        replay_key_seam(mp)
        for fmt, out in (("infer", "Ek_r8.txt"), ("run", "energy.txt")):
            args = ["taylorgreen", "energy", "--exp", str(exp),
                    "--resolution", "8", "--fmt", fmt]
            jreplay.main(args)
            want = np.loadtxt(exp / out, comments=("Ek", "#"), ndmin=1)
            treplay.main(args + ["--device", "cpu"])
            got = np.loadtxt(exp / out, comments=("Ek", "#"), ndmin=1)
            assert got.shape == want.shape and got.size >= 1
            np.testing.assert_allclose(got, want, rtol=1e-5)
        args = ["taylorgreen", "vorticity", "--exp", str(exp),
                "--resolution", "12"]
        capture_frames(mp, jvis, frames["jax"])
        jreplay.main(args)
        capture_frames(mp, tvis, frames["torch"])
        treplay.main(args + ["--device", "cpu"])
    assert sorted(frames["torch"]) == sorted(frames["jax"]) == [
        "vorticity_t000.png", "vorticity_t001.png"]
    for k, want in frames["jax"].items():
        np.testing.assert_allclose(frames["torch"][k], want, rtol=1e-4,
                                   atol=5e-5)


def test_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing (a card's machine may have none),
    --draw is a usage error before anything is written, and --density
    writes the 2D density frames as npz beside error_ours.txt."""
    monkeypatch.setattr(tvis, "have_matplotlib", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as exc:
        trun.main(["taylorgreen", "--draw", "--out", str(out),
                   "--device", "cpu"])
    assert exc.value.code == 2 and not out.exists()
    trun.main(["taylorgreen", "--density", "--out", str(out), "--device",
               "cpu", "--n_timesteps", "1", "--max_n_iters", "5",
               "--sample_resolution", "8", "--wost_resolution", "8",
               "--div_resolution", "8", "--n_walks", "8", "--fit_pool", "4",
               "--density_resolution", "16"])
    exp = out / "taylorgreen"
    for t in (0, 1):
        with np.load(exp / "density" / f"density_t{t:03d}.npz") as z:
            assert z.files == ["density"]
            assert z["density"].shape == (16, 16)
    assert np.loadtxt(exp / "error_ours.txt").shape == (2,)
    assert not list((exp / "density").glob("*.png"))


def test_profile_dir_writes_a_trace(tmp_path):
    """--profile_dir writes a torch.profiler chrome trace of the first
    step (on the CPU here: CPU activities only)."""
    prof = tmp_path / "prof"
    trun.main(["taylorgreen", "--out", str(tmp_path), "--device", "cpu",
               "--profile_dir", str(prof)] + CLI_TINY
              + ["--fit_mode", "fused", "--fit_pool", "4"])
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
