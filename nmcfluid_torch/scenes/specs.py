"""Scene specifications (port of scenes/specs.py: Taylor-Green, the
karman family, jpipe and the four shipped 3D scenes).

Taylor-Green (examples/taylorgreen/run.sh): the closed square
[0.000447, 6.279553]^2 with analytic wall queries, a 6 x 64 SIREN, 64^2
training batches, a 512^2 pressure cloud with 500 walks, sigma = 350.

karman (examples/karman/run.sh): the open channel x in [-1.10321,
1.906778], y in [-0.598466, 0.60349] (top and bottom walls, inlet and
outlet open) around one circle at (-0.803568, -0.005022), r = 0.044532,
measured from examples/karman/geometry_1cyl_long_open.obj; a 2 x 128
SIREN, 128^2 training batches, fresh weights for every phase fit
(reset_wts), a ramp width of 3e-2 that the driver halves after the
initial fit (main.py:161-163). karman2cyl and karman3cyl are the
reference's 2- and 3-cylinder channels (src/3d/wost/geometry_2cyl.obj,
geometry_3cyl.obj, measured) with karman's hyperparameters.

The 3D scenes (examples/{smoke3d,smoke_obs,vortex_collide,karman3d}/
run.sh) all walk the closed cube [-1, 1]^3 (cube.obj); their obstacles
(smoke_obs's sphere, karman3d's cylinder along y) live only in the hard
boundary conditions and the rejection sampler. Each has 128^2 training
batches, a 256^2 pressure cloud with 500 walks and an 80^3 divergence grid
(vis_resolution); smoke, smoke_obs and vortex_collide train a 5 x 64
SIREN, karman3d a 2 x 128 one.

jpipe (src/2d, no shipped example directory): a J-shaped duct in [0, 2]^2,
open at its inlet (x = 0) and outlet (y = 2), walked as a segment soup
(geometry/soup2d.py, geometry/queries2d.py): a horizontal run, a
quarter-annulus elbow of radii 0.5 and 1 around (1, 1) and a vertical
run; karman's hyperparameters, but the ramp width is not halved after
the initial fit (the JAX CLI halves it for the karman family only).
"""
import dataclasses
import math
from functools import cached_property
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..geometry import sdf
from ..geometry.analytic2d import FAR, make_analytic2d
from ..geometry.analytic3d import make_box3d
from ..geometry.soup2d import build_segments, polyline_chain
from ..geometry.soup3d import box_tris, build_triangles
from ..geometry.sdf import dist_to
from ..models.boundary import JET_CENTER
from ..wost.solver import WalkSettings

# measured from examples/karman/geometry_1cyl_long_open.obj
KARMAN_BBOX = (-1.10321, 1.906778, -0.598466, 0.60349)
KARMAN_OBS_C = (-0.803568, -0.005022)
KARMAN_OBS_R = 0.044532
TG_LO, TG_HI = 0.000447, 6.279553   # examples/taylorgreen/square.obj
# measured from src/3d/wost/geometry_2cyl.obj and geometry_3cyl.obj
NCYL_BBOX = (-1.995, 1.9942, -0.995, 0.9942)
CYL2_OBS = ((-1.0004, -0.0004, 0.1310), (-0.0004, -0.0004, 0.1312))
CYL3_OBS = ((-1.0004, -0.0004, 0.1310), (-0.0004, 0.1496, 0.1310),
            (-0.0004, -0.1504, 0.1310))


@dataclasses.dataclass(frozen=True, eq=False)
class SceneSpec:
    name: str
    dim: int
    scene_size: Tuple[float, ...]       # (xmin,xmax,ymin,ymax[,zmin,zmax])
    # training hyperparameters (examples/*/run.sh)
    num_hidden_layers: int
    hidden_features: int
    dt: float
    sample_resolution: int
    wost_resolution: int
    vel_vis_resolution: int
    bdry_eps: float
    # the 3D divergence grid is vis_resolution^3 (3d/model_split.py:268);
    # 2D scenes keep the reference's fixed 1000^2 (model_split.py:255)
    vis_resolution: int = 1000
    lr: float = 1e-5
    max_n_iters: int = 10_000
    early_stop_loss: float = 1.1e-10    # base.py:148
    # frames of a run (examples/*/run.sh --n_timesteps)
    n_timesteps: int = 200
    # the CLI re-fits the source while 0 < t < src_duration (main.py:164)
    src_duration: int = 1               # config.py --src_duration default
    reset_wts: bool = True
    # the reference halves the 2D karman family's ramp width after the
    # initial fit (main.py:161-163); karman3d keeps it
    halve_eps_after_source: bool = False
    karman_vel: float = 0.5
    nonlinearity: str = "sine"
    sample_pattern: str = "random"      # config.py --sample (all examples)
    # WoSt block (wost.json; identical across shipped examples)
    absorption: float = 350.0
    n_walks: int = 500
    boundary_distance_mask: float = 1e-3
    # obstacles: one circle (karman), a tuple of (cx, cy, r) circles, a
    # sphere (smoke_obs) or a cylinder along y centred at (x, z) (karman3d)
    obstacle_center: Optional[Tuple[float, ...]] = None
    obstacle_radius: Optional[float] = None
    obstacles: Optional[Tuple[Tuple[float, float, float], ...]] = None
    # "y" for karman3d's cylinder (the axis the spectral correction takes)
    obstacle_axis: Optional[str] = None
    _boundary_builder: Optional[Callable] = None
    _obstacle_sdf_builder: Optional[Callable] = None
    _source_builder: Optional[Callable] = None

    @cached_property
    def boundary(self):
        """Neumann boundary for the WoSt solve (on the CPU; move it with
        `.to(device)`)."""
        return self._boundary_builder(self)

    @cached_property
    def obstacle_sdf(self):
        """sdf > 0 in the fluid, or None. The radius includes
        boundaryDistanceMask (src/2d/main.py:96)."""
        if self._obstacle_sdf_builder is None:
            return None
        return self._obstacle_sdf_builder(self)

    @property
    def has_obstacle(self):
        return self._obstacle_sdf_builder is not None

    def source_velocity(self, x, key=None):
        """Initial velocity at points x (src/{2d,3d}/sources.py); smoke
        draws its jitter from the key object `key`."""
        return self._source_builder(self, x, key)

    def eps_after_source(self, eps):
        """The ramp width the steps use once add_source has run."""
        return eps / 2 if self.halve_eps_after_source else eps

    def walk_settings(self, **over):
        kw = dict(n_walks=self.n_walks)
        kw.update(over)
        return WalkSettings(**kw)

    def fluid_mask(self, x):
        """True where x is in the trainable fluid region (the reference's
        rejection filter in sample_in_training, base.py:239-249)."""
        if self.name == "jpipe":
            return sdf.jpipe_interior_mask()(x)
        m = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        if self.obstacle_sdf is not None:
            m = m & (self.obstacle_sdf(x) > 0.0)
        return m


# ------------------------------------------------------------------ sources

def _tg_source(spec, x, key):
    """Taylor-Green initial velocity, rescaled from the scene box to
    (0, 2pi)^2 (src/2d/sources.py:19-31)."""
    ss = spec.scene_size
    sx = (x[..., 0] - ss[0]) / (ss[1] - ss[0]) * 2.0 * math.pi
    sy = (x[..., 1] - ss[2]) / (ss[3] - ss[2]) * 2.0 * math.pi
    u = torch.sin(sx) * torch.cos(sy)
    v = -torch.cos(sx) * torch.sin(sy)
    return torch.stack([u, v], dim=-1)


def _karman_source(spec, x, key):
    """Uniform inflow ramped off the obstacles (src/2d/sources.py:33-42)."""
    vel = torch.stack([torch.full(x.shape[:-1], spec.karman_vel,
                                  device=x.device),
                       torch.zeros(x.shape[:-1], device=x.device)], dim=-1)
    w = torch.clamp(spec.obstacle_sdf(x), 0.0, spec.bdry_eps) / spec.bdry_eps
    return vel * w[..., None]


def _jpipe_source(spec, x, key):
    """Inflow in the horizontal run, ramped off the walls and zero
    outside the pipe (src/2d/sources.py:44-66)."""
    u = torch.where(x[..., 0] < 1.4, spec.karman_vel, 0.0)
    vel = torch.stack([u, torch.zeros_like(u)], dim=-1)
    w = torch.clamp(sdf.jpipe_walls()(x), 0.0, spec.bdry_eps) / spec.bdry_eps
    vel = vel * w[..., None]
    return torch.where(sdf.jpipe_interior_mask()(x)[..., None], vel, 0.0)


def _smoke_source(spec, x, key):
    """Jet sphere at (0, 0, -0.6), r = 0.11, w ~ 0.2 + jitter
    (src/3d/sources.py:22-49): one uniform a point from `key`, as the JAX
    package draws it (the reference's numpy jitter has no fixed seed)."""
    if key is None:
        raise ValueError("smoke's source draws its jitter: pass a key")
    mask = dist_to(x, JET_CENTER) < 0.11
    r = 10.0 * (2.0 * key.uniform(x.shape[:-1], x.device) - 1.0)
    jet = torch.stack([0.01 * r, 0.01 * r, 0.2 + 0.01 * r], dim=-1)
    return torch.where(mask[..., None], jet, 0.0)


def _smoke_obs_source(spec, x, key):
    """w = 1 inside the jet sphere (src/3d/sources.py:51-68)."""
    w = torch.where(dist_to(x, JET_CENTER) < 0.11, 1.0, 0.0)
    z = torch.zeros_like(w)
    return torch.stack([z, z, w], dim=-1)


def _vortex_collide_source(spec, x, key):
    """Two opposed jets with a cos(8 theta) azimuthal perturbation
    (src/3d/sources.py:70-93), theta the angle of each point's own (x, y)
    offset from the jet axis, as the JAX package implements it."""
    def ring(center, sign, cx=0.2, cy=0.2):
        mask = dist_to(x, center) < 0.2
        d = torch.stack([x[..., 0] - cx, x[..., 1] - cy], dim=-1)
        d = d / torch.clamp(dist_to(d, (0.0, 0.0)), min=1e-12)[..., None]
        theta = torch.arccos(torch.clamp(d[..., 0], -1.0, 1.0))
        w = sign * 0.2 * (1.0 + 0.01 * torch.cos(8.0 * theta))
        return torch.where(mask, w, 0.0)
    w = ring((0.0, 0.0, -0.21), 1.0) + ring((0.0, 0.0, 0.21), -1.0,
                                            cx=0.201, cy=0.2)
    z = torch.zeros_like(w)
    return torch.stack([z, z, w], dim=-1)


def _karman3d_source(spec, x, key):
    """Uniform +z inflow ramped off the cylinder (src/3d/sources.py:
    95-104)."""
    ramp = torch.clamp(spec.obstacle_sdf(x), 0.0, spec.bdry_eps) \
        / spec.bdry_eps
    z = torch.zeros_like(ramp)
    return torch.stack([z, z, spec.karman_vel * ramp], dim=-1)


# ----------------------------------------------------------------- geometry

def _tg_boundary(spec):
    """Closed square box with analytic closed-form queries."""
    return make_analytic2d((TG_LO, TG_LO), (TG_HI, TG_HI))


def _channel(scene_size, circles):
    """Open channel (y walls only; inlet and outlet open) + exact circles;
    the wall chains' corner endpoints are always-silhouette points like
    the reference asset's open-chain ends."""
    x0, x1, y0, y1 = scene_size
    corners = [(x0, y0), (x1, y0), (x0, y1), (x1, y1)]
    return make_analytic2d((-FAR, y0), (FAR, y1), circles=circles,
                           sil_pts=corners, bbox=((x0, y0), (x1, y1)))


def _karman_boundary(spec):
    return _channel(KARMAN_BBOX, [(*KARMAN_OBS_C, KARMAN_OBS_R)])


def _ncyl_boundary(spec):
    return _channel(spec.scene_size, list(spec.obstacles))


def _ncyl_sdf(spec):
    """min over the circle SDFs, each grown by boundaryDistanceMask (the
    reference grows its fitted circle the same way, main.py:96)."""
    fns = [sdf.circle((cx, cy), r + spec.boundary_distance_mask)
           for cx, cy, r in spec.obstacles]

    def f(x):
        d = fns[0](x)
        for g in fns[1:]:
            d = torch.minimum(d, g(x))
        return d
    return f


def _karman_sdf(spec):
    return sdf.circle(KARMAN_OBS_C,
                      KARMAN_OBS_R + spec.boundary_distance_mask)


def _jpipe_boundary(spec):
    """The J-pipe's inner and outer walls as two open chains (inlet at
    x = 0 and outlet at y = 2 open), normals out of the fluid between
    them."""
    th = np.linspace(0.0, 0.5 * np.pi, 21)
    # outer wall: the y = 0 run, the r = 1 elbow, the x = 2 run; fluid left
    outer = ([(0.0, 0.0)]
             + [(1.0 + np.sin(t), 1.0 - np.cos(t)) for t in th]
             + [(2.0, 2.0)])
    # inner wall: the y = 0.5 run, the r = 0.5 elbow, the x = 1.5 run,
    # traversed backwards so that the fluid is on its left too
    inner = ([(0.0, 0.5)]
             + [(1.0 + 0.5 * np.sin(t), 1.0 - 0.5 * np.cos(t)) for t in th]
             + [(1.5, 2.0)])
    return build_segments([polyline_chain(np.asarray(outer)),
                           polyline_chain(np.asarray(inner)[::-1])])


def _jpipe_sdf(spec):
    return sdf.jpipe_walls()


def _cube_boundary(spec):
    """The closed cube [-1, 1]^3 with analytic slab queries."""
    return make_box3d((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def _cube_boundary_soup(spec):
    """The same cube as the reference's 12-triangle cube.obj, walked as a
    triangle soup (geometry/queries3d.py)."""
    v, f = box_tris((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    return build_triangles(v, f)


def _smoke_obs_sdf(spec):
    return sdf.sphere(spec.obstacle_center, spec.obstacle_radius)


def _karman3d_sdf(spec):
    return sdf.cylinder_xz(spec.obstacle_center, spec.obstacle_radius)


# ------------------------------------------------------------------ catalog

_KARMAN_FAMILY = dict(
    dim=2, num_hidden_layers=2, hidden_features=128, dt=0.05,
    sample_resolution=128, wost_resolution=512, vel_vis_resolution=200,
    bdry_eps=3e-2, karman_vel=0.5, halve_eps_after_source=True,
    _source_builder=_karman_source)

CUBE = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
_CUBE_SCENE = dict(
    dim=3, scene_size=CUBE, dt=0.05, sample_resolution=128,
    wost_resolution=256, vis_resolution=80, vel_vis_resolution=100,
    bdry_eps=1e-2, _boundary_builder=_cube_boundary)
_SMOKE_NET = dict(num_hidden_layers=5, hidden_features=64)

SCENES = {
    # examples/taylorgreen/run.sh
    "taylorgreen": SceneSpec(
        name="taylorgreen", dim=2,
        scene_size=(TG_LO, TG_HI, TG_LO, TG_HI),
        num_hidden_layers=6, hidden_features=64, dt=0.001, n_timesteps=100,
        sample_resolution=64, wost_resolution=512, vel_vis_resolution=60,
        bdry_eps=1e-3, reset_wts=False,
        _boundary_builder=_tg_boundary, _source_builder=_tg_source),
    # examples/karman/run.sh
    "karman": SceneSpec(
        name="karman", scene_size=KARMAN_BBOX,
        obstacle_center=KARMAN_OBS_C, obstacle_radius=KARMAN_OBS_R,
        _boundary_builder=_karman_boundary,
        _obstacle_sdf_builder=_karman_sdf, **_KARMAN_FAMILY),
    # the reference's 2- and 3-cylinder channels; hyperparameters as karman
    "karman2cyl": SceneSpec(
        name="karman2cyl", scene_size=NCYL_BBOX, obstacles=CYL2_OBS,
        _boundary_builder=_ncyl_boundary, _obstacle_sdf_builder=_ncyl_sdf,
        **_KARMAN_FAMILY),
    "karman3cyl": SceneSpec(
        name="karman3cyl", scene_size=NCYL_BBOX, obstacles=CYL3_OBS,
        _boundary_builder=_ncyl_boundary, _obstacle_sdf_builder=_ncyl_sdf,
        **_KARMAN_FAMILY),
    # supported by src/2d (no shipped example directory); karman's
    # hyperparameters, the ramp width kept after the initial fit
    "jpipe": SceneSpec(
        name="jpipe", dim=2, scene_size=(0.0, 2.0, 0.0, 2.0),
        num_hidden_layers=2, hidden_features=128, dt=0.05,
        sample_resolution=128, wost_resolution=512, vel_vis_resolution=200,
        bdry_eps=3e-2, karman_vel=0.5,
        _boundary_builder=_jpipe_boundary, _source_builder=_jpipe_source,
        _obstacle_sdf_builder=_jpipe_sdf),
    # examples/smoke3d/run.sh
    "smoke": SceneSpec(name="smoke", _source_builder=_smoke_source,
                       **_SMOKE_NET, **_CUBE_SCENE),
    # examples/smoke_obs/run.sh; the sphere of src/3d/main.py:87-89
    "smoke_obs": SceneSpec(
        name="smoke_obs", obstacle_center=(0.0, 0.0, -0.3),
        obstacle_radius=0.1, _source_builder=_smoke_obs_source,
        _obstacle_sdf_builder=_smoke_obs_sdf, **_SMOKE_NET, **_CUBE_SCENE),
    # examples/vortex_collide/run.sh
    "vortex_collide": SceneSpec(
        name="vortex_collide", _source_builder=_vortex_collide_source,
        **_SMOKE_NET, **_CUBE_SCENE),
    # examples/karman3d/run.sh; the cylinder of src/3d/main.py:92-94
    "karman3d": SceneSpec(
        name="karman3d", num_hidden_layers=2, hidden_features=128,
        karman_vel=0.5, n_timesteps=500, obstacle_center=(0.0, -0.8), obstacle_radius=0.1,
        obstacle_axis="y",
        _source_builder=_karman3d_source,
        _obstacle_sdf_builder=_karman3d_sdf, **_CUBE_SCENE),
}



def get_scene(name: str) -> SceneSpec:
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    return SCENES[name]
