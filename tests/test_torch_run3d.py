"""The port's command line on a 3D scene against the JAX package's, on the
CPU, at tiny sizes: smoke with --adv_ref 1 --draw --density
--vis_frequency, one run of each CLI (tests/_torch_parity.py::cli_pair,
the key seam replaying jax.random). It holds what tests/test_torch_run.py
holds in 2D: (a, e) the checkpoints of an adv_ref step, four fits, at the
smoke family's chained-step tolerance rtol 2e-4 / atol 1e-3
(tests/test_torch_3d_step.py); (b) the same files; (c) --density_only
over the JAX CLI's checkpoints; (g) replay energy.
"""
import shutil

import numpy as np
import pytest

from _torch_parity import (CLI_TINY, assert_ckpts_match, assert_same_files,
                           cli_pair, replay_key_seam)

import nmcfluid.replay as jreplay
import nmcfluid_torch.replay as treplay
import nmcfluid_torch.run as trun

EXTRA = ["--adv_ref", "1", "--draw", "--density", "--vis_frequency", "5"]


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    return cli_pair(tmp_path_factory.mktemp("smoke"), "smoke", EXTRA)


def test_adv_ref_checkpoints_match_jax(smoke_runs):
    jdir, tdir, _ = smoke_runs
    assert_ckpts_match(jdir, tdir, [1e-3])
    traces = sorted(p.name for p in (tdir / "txt").glob("loss_*"))
    assert traces == ["loss_advect2_t001.txt", "loss_advect_t001.txt",
                      "loss_project2_t001.txt", "loss_project_t001.txt"]


def test_same_files_under_draw_density_vis_frequency_3d(smoke_runs):
    jdir, tdir, _ = smoke_runs
    assert_same_files(jdir, tdir)


def test_density_only_on_jax_checkpoints_3d(smoke_runs, tmp_path):
    """The density npz files (density and raw velocity; smoke's initial
    jitter drawn through the key seam) at the rollout tolerance rtol 1e-5
    / atol 1e-6 (tests/test_torch_transport.py); no error file off
    Taylor-Green."""
    jdir, _, _ = smoke_runs
    exp = tmp_path / "smoke"
    shutil.copytree(jdir / "model", exp / "model")
    with pytest.MonkeyPatch.context() as mp:
        replay_key_seam(mp)
        trun.main(["smoke", "--density_only", "--out", str(tmp_path),
                   "--device", "cpu"] + CLI_TINY)
    for t in (0, 1):
        name = f"density/density_t{t:03d}.npz"
        with np.load(exp / name) as a, np.load(jdir / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["density", "vel"]
            for k in b.files:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)
    assert not (exp / "error_ours.txt").exists()


def test_replay_energy_matches_jax_3d(smoke_runs, tmp_path):
    """Ek_r8.txt (with the source's energy, smoke's jitter drawn through
    the key seam) at the rollout rtol 1e-5."""
    exp = tmp_path / "smoke"
    shutil.copytree(smoke_runs[0] / "model", exp / "model")
    args = ["smoke", "energy", "--exp", str(exp), "--resolution", "8"]
    with pytest.MonkeyPatch.context() as mp:
        replay_key_seam(mp)
        jreplay.main(args)
        want = np.loadtxt(exp / "Ek_r8.txt", comments="Ek")
        treplay.main(args + ["--device", "cpu"])
    got = np.loadtxt(exp / "Ek_r8.txt", comments="Ek")
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
