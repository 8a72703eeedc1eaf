"""The port's transport (nmcfluid_torch/transport/density.py), differential
operators (ops/diff_ops.py) and the "uniform" and "random+uniform" sample
patterns against the JAX package, on the CPU, from the same numpy inputs
and the JAX-replay key.

Tolerances: the initial density and the sample patterns compute the same
float32 operations in the same order, rtol 1e-6; one density pull too, but
XLA may rewrite the index's division as a product with the reciprocal,
and an ulp of an index (up to 14 here: these fields carry points five
cells past the grid) moves a weight by up to 9.5e-7, so the pull is held
to atol 2e-6; a rollout chains pulls and network evaluations through seven
sin(30 z) layers, rtol 1e-5 / atol 1e-6 and the TG error rtol 1e-5; the
derivatives are f32 forward-mode Jacobians through the same layers, held
to the divergence grid's tolerance in tests/test_torch_step.py, rtol 1e-4
/ atol 5e-5.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, to_np

import nmcfluid.ops.diff_ops as j_diff
import nmcfluid.transport.density as j_dens
from nmcfluid.models.siren import SirenConfig as JCfg
from nmcfluid.models.siren import apply_siren as j_apply
from nmcfluid.models.siren import init_siren as j_init
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import sampling as j_sampling
import nmcfluid_torch.ops.diff_ops as t_diff
import nmcfluid_torch.transport.density as t_dens
from nmcfluid_torch.models.siren import SirenConfig as TCfg
from nmcfluid_torch.models.siren import apply_siren as t_apply
from nmcfluid_torch.models.siren import params_from_numpy
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.sim import sampling as t_sampling


@pytest.mark.parametrize("scene", ["taylorgreen", "smoke",
                                   "vortex_collide"])
def test_init_density_matches(scene):
    n = 12
    j = j_dens.init_density(j_get_scene(scene), n)
    t = t_dens.init_density(t_get_scene(scene), n, key=JaxKey.from_seed(0))
    if scene == "vortex_collide":
        np.testing.assert_array_equal(to_np(t[1]), np.asarray(j[1]))
        assert to_np(t[1]).sum() > 0
        j, t = j[0], t[0]
    np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-6, atol=0)
    assert float(t.max()) > 0


@pytest.mark.parametrize("dim,mode", [(2, "constant"), (2, "nearest"),
                                      (3, "constant"), (3, "nearest")])
def test_advect_density_matches_map_coordinates(dim, mode):
    """A random density pulled by a field whose back traces leave the grid
    across every face, and land on and between the cells inside."""
    n = 9
    rng = np.random.default_rng(dim)
    ss = j_get_scene("taylorgreen" if dim == 2 else "smoke").scene_size
    d = rng.random((n,) * dim).astype(np.float32)
    ext = ss[1] - ss[0]
    dt = 0.05
    vel = (rng.uniform(-1.0, 1.0, (n,) * dim + (dim,)) * 0.6 * ext
           / dt).astype(np.float32)
    back = (np.asarray(j_dens._index_grid(ss, n, dim)) - dt * vel)
    for i in range(dim):
        assert (back[..., i] < ss[0]).any() and (back[..., i] > ss[1]).any()
    j = j_dens.advect_density(jnp.asarray(d), jnp.asarray(vel), ss, dt, mode)
    t = t_dens.advect_density(torch.from_numpy(d), torch.from_numpy(vel),
                              ss, dt, mode)
    np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-6, atol=2e-6)


def _net(dim, seed, hidden=3):
    cfg = JCfg(dim, dim, num_hidden_layers=hidden, hidden_features=16)
    return cfg, [(np.asarray(W), np.asarray(b))
                 for W, b in j_init(jax.random.PRNGKey(seed), cfg)]


@pytest.mark.parametrize("scene", ["taylorgreen", "smoke"])
def test_transport_rollout_matches(scene):
    """Three frames: TG pulls every frame and yields each frame's error;
    smoke skips the pull at t = 0."""
    js, ts = j_get_scene(scene), t_get_scene(scene)
    dim = js.dim
    jcfg, _ = _net(dim, 0)
    frames = [_net(dim, s)[1] for s in range(3)]

    # the rollouts read the fluid's scene, network config and device only
    jfl = SimpleNamespace(scene=js, siren_cfg=jcfg)
    tfl = SimpleNamespace(scene=ts, device=torch.device("cpu"),
                          siren_cfg=TCfg(dim, dim, num_hidden_layers=3,
                                         hidden_features=16))
    n = 16 if dim == 2 else 8
    jr = list(j_dens.transport_rollout(
        jfl, [[(jnp.asarray(W), jnp.asarray(b)) for W, b in p]
             for p in frames], n=n))
    tr = list(t_dens.transport_rollout(
        tfl, [params_from_numpy(p) for p in frames], n=n,
        key=JaxKey.from_seed(0)))
    assert len(tr) == len(jr) == 3
    d0 = to_np(t_dens.init_density(ts, n, key=JaxKey.from_seed(0)))
    for (tt, dt_, vt, et), (tj, dj, vj, ej) in zip(tr, jr):
        assert tt == tj
        np.testing.assert_allclose(to_np(vt), np.asarray(vj), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(to_np(dt_), np.asarray(dj), rtol=1e-5,
                                   atol=1e-6)
        if scene == "taylorgreen":
            np.testing.assert_allclose(et, ej, rtol=1e-5)
        else:
            assert et is None and ej is None
        if tt == 0:
            # 3D keeps the initial density at t = 0; 2D has pulled it
            assert np.array_equal(to_np(dt_), d0) == (dim == 3)


def _fields(dim):
    cfg, p = _net(dim, 4)
    tcfg = TCfg(dim, dim, num_hidden_layers=3, hidden_features=16)
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in p]
    tp = params_from_numpy(p)
    x = np.random.default_rng(dim).uniform(-1, 1, (5, 7, dim)).astype(
        np.float32)
    return ((lambda y: j_apply(jp, cfg, y)), (lambda y: t_apply(tp, tcfg, y)),
            x)


@pytest.mark.parametrize("op,dim", [("jacobian", 2), ("jacobian", 3),
                                    ("divergence", 2), ("divergence", 3),
                                    ("curl2d", 2), ("curl3d", 3),
                                    ("gradient", 2), ("gradient", 3)])
def test_diff_ops_match(op, dim):
    fj, ft, x = _fields(dim)
    if op == "gradient":
        fj0, ft0 = fj, ft
        fj = lambda y: jnp.sum(fj0(y) ** 2)          # noqa: E731
        ft = lambda y: torch.sum(ft0(y) ** 2, -1)    # noqa: E731
    j = getattr(j_diff, op)(fj, jnp.asarray(x))
    t = getattr(t_diff, op)(ft, torch.from_numpy(x))
    assert tuple(t.shape) == j.shape
    np.testing.assert_allclose(to_np(t), np.asarray(j), rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("scene", ["taylorgreen", "karman", "smoke_obs"])
@pytest.mark.parametrize("pattern", ["uniform", "random+uniform"])
@pytest.mark.parametrize("n", [64, 50])
def test_sample_patterns_match(scene, pattern, n):
    """The grid tiled and cut to n points (n = 50 is no grid's size), the
    random half drawn with the same key, validity off the obstacles."""
    key = jax.random.PRNGKey(3)
    js, ts = j_get_scene(scene), t_get_scene(scene)
    res = 6 if js.dim == 2 else 3
    pj, vj = j_sampling.training_points(key, n, js, pattern, res)
    pt, vt = t_sampling.training_points(JaxKey(key), n, ts, pattern, res)
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(to_np(vt), np.asarray(vj))
