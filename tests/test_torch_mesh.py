"""The points mesh (parallel/mesh.py, NeuralFluid(mesh=...)) on the CPU.

Port of tests/test_parallel.py:17-113 on a mesh of CPU devices listed
explicitly (["cpu", "cpu"]), which exercises the split on one device:
the pressure solve's chunks are cut into one contiguous block of whole
chunks a device (the chunk halved where the devices outnumber the
chunks), each block walked in its own host thread. Every chunk then
walks as in the meshless solve at the same chunk size, so the sharded
solve equals the meshless one bit for bit (the JAX package holds its
sharded solve to rtol 2e-5), under both executors and both sources, and
so does a whole sharded step.
"""
import threading

import numpy as np
import pytest
import torch

import nmcfluid_torch.run as trun
import nmcfluid_torch.sim.fluid as tfluid
from nmcfluid_torch.parallel import points_mesh, replicate, shard_points
from nmcfluid_torch.parallel.mesh import shard_bounds
from nmcfluid_torch.scenes import get_scene
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost.solver import WalkSettings

KW = dict(sample_resolution=8, wost_resolution=16, div_resolution=16,
          max_n_iters=2, fit_pool=4, device="cpu")


def test_points_mesh():
    """An explicit list is taken as given (repeats allowed); without one,
    the first n CUDA devices, and asking for more than exist raises."""
    assert points_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            points_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        points_mesh(torch.cuda.device_count() + 1)
    mesh = points_mesh(devices=["cpu"] * 3)
    x = torch.arange(20.0).reshape(10, 2)
    parts = shard_points(mesh, x)
    assert [p.shape[0] for p in parts] == [3, 3, 4]
    assert torch.equal(torch.cat(parts), x)
    assert shard_bounds(10, mesh) == [(0, 3), (3, 6), (6, 10)]
    params = [(torch.ones(2, 3), torch.zeros(3))]
    reps = replicate(mesh, (params, 0.5, 7))
    assert len(reps) == 3 and reps[2][1:] == (0.5, 7)
    assert torch.equal(reps[1][0][0][0], params[0][0])


@pytest.fixture(scope="module")
def fluids():
    """A meshless TG fluid and one over a two-device CPU mesh, the same
    settings and chunk size (the mesh's: one chunk a device), and the
    divergence grid of the meshless fluid's initial weights."""
    scene = get_scene("taylorgreen")
    ws = WalkSettings(n_walks=16, walk_step_cap=16)
    fl0 = tfluid.NeuralFluid(scene, walk_settings=ws, **KW)
    fl2 = tfluid.NeuralFluid(scene, walk_settings=ws, mesh=["cpu", "cpu"],
                             **KW)
    fl0.wost_chunk = fl2.wost_chunk
    st = fl0.init_state(0)
    div = tfluid._divergence_grid(fl0, st.params, st.eps, st.timestep)
    return fl0, fl2, st, div


@pytest.mark.parametrize("source", ["grid", "net"])
@pytest.mark.parametrize("algo", ["gen", "pool"])
def test_sharded_pressure_solve_matches_single_device(fluids, algo, source):
    """tests/test_parallel.py:17-45: the sharded solve on the same key
    equals the meshless one, bit for bit, under each executor and each
    source."""
    fl0, fl2, st, div = fluids
    outs = []
    for fl in (fl0, fl2):
        fl.walk_settings = WalkSettings(n_walks=16, walk_step_cap=16,
                                        algo=algo)
        if source == "grid":
            outs.append(tfluid._pressure_solve_wost(
                fl, (div,), Key(11), fl._wost_scene))
        else:
            outs.append(tfluid._pressure_solve_wost(
                fl, (st.params, st.eps, 0), Key(11), fl._wost_scene_net))
    for a, b, what in zip(*outs, ("pts", "valid", "p", "grad p")):
        assert torch.equal(a, b), what


def test_sharded_solve_divides_points_across_devices(fluids, monkeypatch):
    """tests/test_parallel.py:79-113: the walk runs once a device, each on
    N/devices points (one whole chunk: the mesh halves the fluid's one
    chunk), on that device, in a host thread of its own."""
    fl0, fl2, st, div = fluids
    calls = []
    est = tfluid.estimate_solution_and_gradient

    def spy(scene, settings, pts, key, **kw):
        calls.append((pts.shape[0], pts.device,
                      threading.current_thread().name))
        return est(scene, settings, pts, key, **kw)
    monkeypatch.setattr(tfluid, "estimate_solution_and_gradient", spy)
    pts, _, p, g = tfluid._pressure_solve_wost(fl2, (div,), Key(0),
                                               fl2._wost_scene)
    n = pts.shape[0]
    assert n == fl2.n_pressure and fl2.wost_chunk == n // 2
    assert [c[:2] for c in calls] == [(n // 2, torch.device("cpu"))] * 2
    assert len({c[2] for c in calls}) == 2
    assert threading.current_thread().name not in {c[2] for c in calls}
    assert p.shape == (n,) and g.shape == (n, 2)


def test_sharded_step_matches_single_device():
    """tests/test_parallel.py:48-76: a whole step (advection fit, the
    sharded walk, projection fit) from the same state tracks the meshless
    step at the mesh's chunk size (one chunk a device); here the walk is
    the same bit for bit, so the steps are equal (params, P)."""
    scene = get_scene("taylorgreen")
    ws = WalkSettings(n_walks=16, walk_step_cap=16)
    kw = dict(KW, max_n_iters=20, wost_resolution=16)
    fl0 = tfluid.NeuralFluid(scene, walk_settings=ws, **kw)
    fl2 = tfluid.NeuralFluid(scene, walk_settings=ws,
                             mesh=["cpu", "cpu", "cpu"], **kw)
    assert fl2.n_pressure // fl2.wost_chunk == 3
    fl0.wost_chunk = fl2.wost_chunk
    out0 = fl0.step(fl0.init_state(3))
    out2 = fl2.step(fl2.init_state(3))
    assert out2.timestep == 1 and torch.equal(out0.P, out2.P)
    for (w0, b0), (w2, b2) in zip(out0.params, out2.params):
        assert torch.equal(w0, w2) and torch.equal(b0, b2)
    u0 = fl0.sample_velocity_grid(out0, 12)
    u2 = fl2.sample_velocity_grid(out2, 12)
    assert torch.equal(u0, u2)


def test_cli_mesh(tmp_path, monkeypatch):
    """--mesh 2 --device cpu runs from the CLI (two CPU copies) and writes
    the checkpoints of the meshless run at its chunk size (half the
    cloud) bit for bit."""
    make = trun.make_fluid

    def halved(a):
        fl = make(a)
        fl.wost_chunk = fl.n_pressure // 2
        return fl
    args = ["taylorgreen", "--device", "cpu", "--n_timesteps", "1",
            "--max_n_iters", "10", "--sample_resolution", "8",
            "--wost_resolution", "8", "--div_resolution", "16",
            "--n_walks", "8", "--fit_pool", "4"]
    trun.main(args + ["--mesh", "2", "--out", str(tmp_path / "two")])
    monkeypatch.setattr(trun, "make_fluid", halved)
    trun.main(args + ["--out", str(tmp_path / "one")])
    for t in (0, 1):
        name = f"taylorgreen/model/ckpt_step_t{t:03d}.npz"
        with np.load(tmp_path / "one" / name) as a, \
                np.load(tmp_path / "two" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
