"""The karman configuration's plain reference (nmcbench/configs/karman.py)
against the port, on the CPU at a small size.

- The port's spectral pressure solve (`_pressure_solve_spectral`, the DCT
  box solve plus the circle's Bessel-K modal correction) at sigma = 350,
  before the boundary masking, against the reference's `pressure` on a
  64 x 26 grid and 4,096 cloud points; the same comparison with the port's
  correction zeroed misses by at least ten times the tolerance.
- The hard boundary conditions' affine map, the fluid mask and the
  distance to the channel's walls and circle against models/boundary.py,
  the scene's fluid mask and the channel's distance query, on seeded
  points that include the inlet band's edge and the circle's rim.
- The span `obstacle_modes` and the counter `resample_points` appear in
  a karman step's stage_times and not in a Taylor-Green one's.

The reference and the configuration are the benchmark's own files
(nmcbench/configs/karman.py and karman.json), loaded by path: this test
holds the port to them as they stand, and follows them if they change.
"""
import dataclasses
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
from nmcfluid_torch.ops import circle_modes
from nmcfluid_torch.scenes import get_scene
from nmcfluid_torch.sim import fluid as fluid_mod
from nmcfluid_torch.sim.fluid import NeuralFluid
from nmcfluid_torch.sim.sampling import grid_resolutions
from nmcfluid_torch.utils.keys import Key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "nmcbench", "configs")
with open(os.path.join(CONFIGS, "karman.json")) as _f:
    CFG = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "ref_karman_test", os.path.join(CONFIGS, "karman.py"))
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)
SF = CFG["scene_fields"]
EPS = SF["bdry_eps"]
# the port runs in float32 against a float64 reference: the DCT solve on
# the 64 x 26 grid and the bilinear lookups round at ~1e-7 of p's scale,
# the modal correction's float32 Bessel-ratio recurrences and its 32-mode
# projection at ~1e-6 of the correction's (it reads 3e-7 and 6e-7 here);
# 5e-6 holds both with room
PRESSURE_RTOL = 5e-6
# A and c of the hard BCs: the ramps divide a float32 distance by
# eps = 0.015, so a rounding of 6e-8 in the distance reads ~4e-6 there
AFFINE_ATOL = 1e-5
# the channel's distance query rounds its float32 circle distance
DIST_ATOL = 1e-6


def _fluid(**over):
    scene = dataclasses.replace(
        get_scene("karman"),
        **{k: tuple(v) if isinstance(v, list) else v for k, v in SF.items()})
    kw = dict(max_n_iters=4, sample_resolution=8, wost_resolution=64,
              div_resolution=64, fit_pool=2, ls_head=2, n_walks=8,
              projection="spectral", device="cpu")
    kw.update(over)
    return NeuralFluid(scene, **kw)


def _rel_rms(a, b):
    a, b = a.double(), b.double()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.sqrt(torch.mean(b ** 2)))


def _solve_gaps(monkeypatch):
    """(p gap, grad p gap) of the port's unmasked solve of a seeded smooth
    divergence grid against the reference's, RMS over the reference's."""
    f = _fluid()
    monkeypatch.setattr(fluid_mod, "_mask_pressure",
                        lambda fluid, pts, valid, p, g: (p, g))
    nx, ny = 64, 26
    assert grid_resolutions(f.scene.scene_size, f.div_resolution) == (nx, ny)
    gen = torch.Generator().manual_seed(21)
    modes = torch.randn(6, 6, generator=gen, dtype=torch.float64)
    x = (torch.arange(nx, dtype=torch.float64) + 0.5) / nx
    y = (torch.arange(ny, dtype=torch.float64) + 0.5) / ny
    div = sum(modes[i, j] * torch.cos(math.pi * i * x)[:, None]
              * torch.cos(math.pi * j * y)[None, :]
              for i in range(6) for j in range(6)) * 40.0
    pts, valid, p, g = fluid_mod._pressure_solve_spectral(
        f, div.float(), Key(2100000021))
    assert bool(valid.all())
    pr, gr = REF.pressure(div, pts, CFG, torch.float64)
    return _rel_rms(p, pr), _rel_rms(g, gr)


def test_spectral_solve_matches_the_reference(monkeypatch):
    gp, gg = _solve_gaps(monkeypatch)
    assert gp < PRESSURE_RTOL and gg < PRESSURE_RTOL, (gp, gg)


def test_dropped_correction_misses_the_reference(monkeypatch):
    real = circle_modes.eval_circle_correction

    def zero(*a, **k):
        q, g = real(*a, **k)
        return torch.zeros_like(q), torch.zeros_like(g)
    monkeypatch.setattr(circle_modes, "eval_circle_correction", zero)
    gp, gg = _solve_gaps(monkeypatch)
    assert max(gp, gg) > 10 * PRESSURE_RTOL, (gp, gg)


def _probe_points(n=4096, seed=5):
    """Seeded points over the channel, and bands of them across the inlet
    band's edge and the rims of the circle and of the grown circle."""
    gen = torch.Generator().manual_seed(seed)
    x0, x1, y0, y1 = SF["scene_size"]
    u = torch.rand(n, 2, generator=gen, dtype=torch.float64)
    box = torch.stack([x0 + u[:, 0] * (x1 - x0), y0 + u[:, 1] * (y1 - y0)],
                      -1)
    edge = float(np.float32(x0) + np.float32(EPS))
    v = torch.rand(n, 2, generator=gen, dtype=torch.float64)
    inlet = torch.stack([edge + (v[:, 0] - 0.5) * 4e-3,
                         y0 + v[:, 1] * (y1 - y0)], -1)
    c, a = SF["obstacle_center"], SF["obstacle_radius"]
    rims = []
    for r in (a, a + SF["boundary_distance_mask"], a + EPS):
        w = torch.rand(n, 2, generator=gen, dtype=torch.float64)
        rad = r + (w[:, 0] - 0.5) * 4e-3
        th = 2.0 * math.pi * w[:, 1]
        rims.append(torch.stack([c[0] + rad * torch.cos(th),
                                 c[1] + rad * torch.sin(th)], -1))
    return torch.cat([box, inlet] + rims).float()


def test_affine_map_matches_the_reference():
    f = _fluid()
    x = _probe_points()
    A, c = f.velocity_affine(x, eps=EPS, t=3)
    Ar, cr, drawn = REF.affine(x.double(), CFG, EPS, 3)
    keep = ~drawn
    assert int(keep.sum()) > 0.99 * x.shape[0]
    dA = (A.double() - Ar).abs().amax(dim=(-1, -2))[keep]
    dc = (c.double() - cr).abs().amax(dim=-1)[keep]
    assert float(dA.max()) < AFFINE_ATOL and float(dc.max()) < AFFINE_ATOL
    # the inlet band is in the sample, where c is the inflow speed
    edge = float(np.float32(SF["scene_size"][0]) + np.float32(EPS))
    inlet = keep & (x[:, 0].double() < edge) & (cr[:, 0] > 0.0)
    assert int(inlet.sum()) > 100
    np.testing.assert_allclose(c[inlet, 0].numpy(), cr[inlet, 0].numpy(),
                               atol=AFFINE_ATOL)


def test_fluid_mask_matches_the_reference():
    f = _fluid()
    x = _probe_points()
    inside, band = REF.fluid_mask(x.double(), CFG)
    port = f.scene.fluid_mask(x)
    keep = ~band
    assert int((~inside & keep).sum()) > 100      # the circle's interior
    assert torch.equal(port[keep], inside[keep])


def test_wall_distance_matches_the_channel_query():
    f = _fluid()
    x = _probe_points()
    gen = torch.Generator().manual_seed(9)
    x0, x1, y0, y1 = SF["scene_size"]
    # points past the y walls too
    out = torch.stack([x0 + torch.rand(256, generator=gen) * (x1 - x0),
                       y1 + (torch.rand(256, generator=gen) - 0.5) * 0.1], -1)
    x = torch.cat([x, out])
    d, outside = REF.wall_distance(x.double(), CFG)
    dist = f.q.distance(f.boundary, x)
    signed = f.q.signed_distance(f.boundary, x)
    np.testing.assert_allclose(torch.abs(dist).double().numpy(), d.numpy(),
                               atol=DIST_ATOL)
    clear = d > 1e-6
    assert int((outside & clear).sum()) > 100
    assert torch.equal((signed >= 0.0)[clear], outside[clear])


@pytest.mark.parametrize("scene", ["karman", "taylorgreen"])
def test_obstacle_span_and_resample_counter(scene):
    f = NeuralFluid(get_scene(scene), max_n_iters=4, sample_resolution=8,
                    wost_resolution=16, div_resolution=64, fit_pool=2,
                    ls_head=2, n_walks=8, projection="spectral",
                    device="cpu")
    f.profile = True
    f.stage_times = {}
    f.step(f.init_state(0))
    st = f.stage_times
    has = scene == "karman"
    assert ("obstacle_modes" in st) == has
    assert ("resample_points" in st) == has
    if has:
        assert st["spectral_solve"] >= st["obstacle_modes"] > 0.0
        # whole batches or groups of 64 points are redrawn
        assert st["resample_points"] % 64 == 0
