"""The port's generation executor against the JAX package's, on the CPU.

Both walk the same streams: the start draws are keyed on (pair, point)
and the continuation draws on (lane step, pair * N + point) through
fastrand, and `rot` comes from the same key through the JAX-replay key
seam. So the two agree to floating-point reduction order, at the
tolerances of tests/test_gen.py (gen vs pool).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKey, mc_band, mc_close, to_np

from nmcfluid.geometry.analytic2d import make_analytic2d as j_box
from nmcfluid.scenes import get_scene as j_get_scene
from nmcfluid.sim import sampling as j_sampling
from nmcfluid.wost import WalkSettings as JSettings, WostScene as JScene
from nmcfluid.wost.gen import estimate_solution_and_gradient_gen as j_gen

from nmcfluid_torch.geometry.analytic2d import make_analytic2d as t_box
from nmcfluid_torch.scenes import get_scene as t_get_scene
from nmcfluid_torch.scenes.specs import (KARMAN_BBOX, KARMAN_OBS_C,
                                         KARMAN_OBS_R)
from nmcfluid_torch.sim import sampling as t_sampling
from nmcfluid_torch.utils.keys import Key
from nmcfluid_torch.wost.gen import estimate_solution_and_gradient_gen \
    as t_gen
from nmcfluid_torch.wost.solver import (WalkSettings as TSettings,
                                        WostScene as TScene)

L = 2.0
SIG = 30.0
KX = math.pi / L
TG_LO, TG_HI = 0.000447, 6.279553
PTS = np.asarray([[1.0, 1.0], [0.4, 0.7], [1.5, 1.6], [0.2, 1.1]],
                 np.float32)


def _manufactured(lib):
    """(Lap - SIG) p = -f with p* = cos(KX x) cos(KX y) on [0, L]^2,
    zero-flux walls: the estimator suite's analytic problem."""
    if lib == "jax":
        src = lambda x: (SIG + 2.0 * KX ** 2) * jnp.cos(KX * x[..., 0]) \
            * jnp.cos(KX * x[..., 1])
        return JScene(dim=2, neumann=j_box((0.0, 0.0), (L, L)),
                      source_fn=src, absorption=SIG)
    src = lambda x: (SIG + 2.0 * KX ** 2) * torch.cos(KX * x[..., 0]) \
        * torch.cos(KX * x[..., 1])
    return TScene(dim=2, neumann=t_box((0.0, 0.0), (L, L)), source_fn=src,
                  absorption=SIG)


def _tg_grid(lib, grid):
    """The fluid's own walk: TG box, sigma = 350, nearest-texel source
    from a divergence grid passed as source_args."""
    ss = (TG_LO, TG_HI, TG_LO, TG_HI)
    if lib == "jax":
        return JScene(dim=2, neumann=j_box((TG_LO, TG_LO), (TG_HI, TG_HI)),
                      source_fn=lambda y, g: j_sampling.nearest_lookup(
                          g, ss, y), absorption=350.0), (jnp.asarray(grid),)
    return TScene(dim=2, neumann=t_box((TG_LO, TG_LO), (TG_HI, TG_HI)),
                  source_fn=lambda y, g: t_sampling.nearest_lookup(g, ss, y),
                  absorption=350.0), (torch.from_numpy(grid),)


def _karman_grid(lib, grid):
    """The karman fluid's walk: the real channel boundary (open inlet and
    outlet, the circle, the corner silhouette points), sigma = 350, and a
    nearest-texel source from a divergence grid of the karman shape."""
    if lib == "jax":
        scene = j_get_scene("karman")
        return JScene(dim=2, neumann=scene.boundary,
                      source_fn=lambda y, g: j_sampling.nearest_lookup(
                          g, scene.scene_size, y),
                      absorption=350.0), (jnp.asarray(grid),)
    scene = t_get_scene("karman")
    return TScene(dim=2, neumann=scene.boundary,
                  source_fn=lambda y, g: t_sampling.nearest_lookup(
                      g, scene.scene_size, y),
                  absorption=350.0), (torch.from_numpy(grid),)


def _karman_points(rng, n):
    """Fluid points: uniform in the channel, and on purpose near the
    circle, the walls, the open inlet and outlet and a corner."""
    x0, x1, y0, y1 = KARMAN_BBOX
    (cx, cy), r = KARMAN_OBS_C, KARMAN_OBS_R
    pts = np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], -1)
    ang = rng.uniform(0, 2 * np.pi, 8)
    rad = r + np.array([2e-3, 5e-3, 1e-2, 2e-2, 3e-3, 4e-2, 1.5e-3, 8e-3])
    pts[:8] = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)
    pts[8:14] = [[0.0, y0 + 2e-3], [0.5, y1 - 5e-3], [x0 + 1e-2, 0.1],
                 [x1 - 1e-2, -0.2], [x0 + 2e-2, y0 + 2e-2],
                 [x1 - 3e-3, y1 - 4e-3]]
    return pts.astype(np.float32)


@pytest.mark.parametrize("case", ["manufactured", "tg_grid", "karman"])
def test_gen_matches_jax_gen(case):
    """n_walks = 48 > 2 * cv_warmup_pairs, so the frozen control variates
    engage. Same walk set => identical valid counts; p and grad at the
    gen-vs-pool tolerances of tests/test_gen.py. The karman case walks the
    channel: walks escape through the open sides and reflect off the
    circle."""
    rng = np.random.default_rng(0)
    if case == "manufactured":
        pts = PTS
        (js, jargs), (ts, targs) = (_manufactured("jax"), ()), \
            (_manufactured("torch"), ())
    elif case == "karman":
        pts = _karman_points(rng, 64)
        grid = rng.normal(size=(1000, 399)).astype(np.float32)
        js, jargs = _karman_grid("jax", grid)
        ts, targs = _karman_grid("torch", grid)
    else:
        pts = rng.uniform(TG_LO, TG_HI, (64, 2)).astype(np.float32)
        pts[:4] = [[TG_LO + 1e-4, 3.0], [3.0, TG_HI - 5e-4], [0.01, 0.02],
                   [6.2, 6.2]]                  # near walls and corners
        grid = rng.normal(size=(24, 24)).astype(np.float32)
        js, jargs = _tg_grid("jax", grid)
        ts, targs = _tg_grid("torch", grid)
    key = jax.random.PRNGKey(3)
    p_j, g_j, n_j = j_gen(js, JSettings(algo="gen"), jnp.asarray(pts), key,
                          48, source_args=jargs)
    p_t, g_t, n_t = t_gen(ts, TSettings(algo="gen"), torch.from_numpy(pts),
                          JaxKey(key), 48, source_args=targs)
    np.testing.assert_array_equal(to_np(n_t), np.asarray(n_j))
    if case == "karman":
        assert (to_np(n_t) < 48).sum() > 10      # walks escaped
    np.testing.assert_allclose(to_np(p_t), np.asarray(p_j), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(to_np(g_t), np.asarray(g_j), rtol=2e-3,
                               atol=2e-4)


def test_gen_solves_manufactured_problem():
    """The port alone, with its own key: the analytic solution and its
    gradient at the tolerances of tests/test_gen.py:63-75."""
    p, grad, n = t_gen(_manufactured("torch"), TSettings(algo="gen"),
                       torch.from_numpy(PTS), Key(0), 2000)
    pstar = np.cos(KX * PTS[:, 0]) * np.cos(KX * PTS[:, 1])
    mc_close(p, pstar, 0.05, "p")
    gx = -KX * np.sin(KX * PTS[:, 0]) * np.cos(KX * PTS[:, 1])
    gy = -KX * np.cos(KX * PTS[:, 0]) * np.sin(KX * PTS[:, 1])
    mc_close(grad, np.stack([gx, gy], -1), 0.15, "grad p")
    assert np.all(to_np(n) > 1700)


def test_router_settings_meet_manufactured_problem():
    """The settings once refused run through the router: the lockstep
    gradient (algo "lockstep", and fast_rng=False, which routes there)
    and adaptive allocation (on the pool, whether the algo is gen or
    pool), each meeting the manufactured problem at 400 walks (p atol
    0.08, grad atol 0.3) with most walks valid; the gen executor itself still refuses the
    threefry RNG as JAX's does (tests/test_torch_lockstep.py holds these
    settings against the JAX package)."""
    from nmcfluid_torch.wost.solver import estimate_solution_and_gradient
    scene = _manufactured("torch")
    pts = torch.from_numpy(PTS)
    pstar = np.cos(KX * PTS[:, 0]) * np.cos(KX * PTS[:, 1])
    gstar = np.stack([-KX * np.sin(KX * PTS[:, 0]) * np.cos(KX * PTS[:, 1]),
                      -KX * np.cos(KX * PTS[:, 0]) * np.sin(KX * PTS[:, 1])],
                     -1)
    for over in (dict(algo="lockstep"), dict(fast_rng=False),
                 dict(adaptive_walks=1.0),
                 dict(algo="pool", adaptive_walks=1.0)):
        p, g, n = estimate_solution_and_gradient(
            scene, TSettings(**over), pts, Key(0), 400)
        mc_close(p, pstar, 0.08, f"p {over}")
        mc_close(g, gstar, 0.3, f"grad p {over}")
        # an adaptive run may stop a point after the first round
        assert np.all(to_np(n) > (64 if "adaptive_walks" in over else 300)
                      ), over
    with pytest.raises(ValueError, match="fast RNG"):
        t_gen(scene, TSettings(fast_rng=False), pts, Key(0), 8)


def test_port_key_walk_error_matches_jax_key():
    """The port's own key (utils/keys.py) gives the walk the same error as
    the JAX-replay key on the manufactured problem: 320 points x 500
    walks, two keys of each class; each RMS error of p and of grad p
    within [0.8, 1.25] x the JAX-replay keys' mean. A key class whose
    streams were correlated would read several times more. The ratio's
    noise falls with the points, not the walks: at 256 points a key of
    keys 0-11 read 82% of the band (port_key_audit.py)."""
    ts = _manufactured("torch")
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(0.1 * L, 0.9 * L, (320, 2)).astype(
        np.float32))
    x, y = pts[:, 0], pts[:, 1]
    p_true = torch.cos(KX * x) * torch.cos(KX * y)
    g_true = torch.stack([-KX * torch.sin(KX * x) * torch.cos(KX * y),
                          -KX * torch.cos(KX * x) * torch.sin(KX * y)], -1)

    def rms(key):
        p, g, _ = t_gen(ts, TSettings(algo="gen"), pts, key, 500)
        return (float(((p - p_true) ** 2).mean().sqrt()),
                float(((g - g_true) ** 2).mean().sqrt()))
    jax_rms = np.mean([rms(JaxKey(jax.random.PRNGKey(s))) for s in (3, 9)],
                      axis=0)
    for seed in (3, 12345):
        for what, got, want in zip(("p", "grad p"), rms(Key(seed)), jax_rms):
            mc_band(got / want, 0.8, 1.25, f"{what} rms, key {seed}")
