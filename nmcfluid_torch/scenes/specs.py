"""Scene specifications (port of scenes/specs.py, Taylor-Green only).

Taylor-Green (examples/taylorgreen/run.sh): the closed square
[0.000447, 6.279553]^2 with analytic wall queries, a 6 x 64 SIREN, 64^2
training batches, a 512^2 pressure cloud with 500 walks, sigma = 350.
The other scenes of the JAX catalog are not ported yet.
"""
import dataclasses
import math
from functools import cached_property
from typing import Callable, Optional, Tuple

import torch

from ..geometry.analytic2d import make_analytic2d
from ..wost.solver import WalkSettings

TG_LO, TG_HI = 0.000447, 6.279553   # examples/taylorgreen/square.obj


@dataclasses.dataclass(frozen=True, eq=False)
class SceneSpec:
    name: str
    dim: int
    scene_size: Tuple[float, ...]       # (xmin, xmax, ymin, ymax)
    # training hyperparameters (examples/*/run.sh)
    num_hidden_layers: int
    hidden_features: int
    dt: float
    sample_resolution: int
    wost_resolution: int
    bdry_eps: float
    lr: float = 1e-5
    max_n_iters: int = 10_000
    reset_wts: bool = True
    nonlinearity: str = "sine"
    sample_pattern: str = "random"      # config.py --sample (all examples)
    # WoSt block (wost.json; identical across shipped examples)
    absorption: float = 350.0
    n_walks: int = 500
    boundary_distance_mask: float = 1e-3
    _boundary_builder: Optional[Callable] = None
    _source_builder: Optional[Callable] = None

    @cached_property
    def boundary(self):
        """Neumann boundary for the WoSt solve (on the CPU; move it with
        `.to(device)`)."""
        return self._boundary_builder(self)

    def source_velocity(self, x, key=None):
        """Initial velocity at points x (src/2d/sources.py)."""
        return self._source_builder(self, x, key)

    def walk_settings(self, **over):
        kw = dict(n_walks=self.n_walks)
        kw.update(over)
        return WalkSettings(**kw)


def _tg_source(spec, x, key):
    """Taylor-Green initial velocity, rescaled from the scene box to
    (0, 2pi)^2 (src/2d/sources.py:19-31)."""
    ss = spec.scene_size
    sx = (x[..., 0] - ss[0]) / (ss[1] - ss[0]) * 2.0 * math.pi
    sy = (x[..., 1] - ss[2]) / (ss[3] - ss[2]) * 2.0 * math.pi
    u = torch.sin(sx) * torch.cos(sy)
    v = -torch.cos(sx) * torch.sin(sy)
    return torch.stack([u, v], dim=-1)


def _tg_boundary(spec):
    """Closed square box with analytic closed-form queries."""
    return make_analytic2d((TG_LO, TG_LO), (TG_HI, TG_HI))


SCENES = {
    # examples/taylorgreen/run.sh
    "taylorgreen": SceneSpec(
        name="taylorgreen", dim=2,
        scene_size=(TG_LO, TG_HI, TG_LO, TG_HI),
        num_hidden_layers=6, hidden_features=64, dt=0.001,
        sample_resolution=64, wost_resolution=512, bdry_eps=1e-3,
        reset_wts=False,
        _boundary_builder=_tg_boundary, _source_builder=_tg_source),
}


def get_scene(name: str) -> SceneSpec:
    if name not in SCENES:
        raise NotImplementedError(
            f"scene {name!r} is not ported yet; have {sorted(SCENES)}")
    return SCENES[name]
