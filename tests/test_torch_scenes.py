"""The port's scene catalog (nmcfluid_torch/scenes) on the CPU: the ramp
width the steps use after add_source, scene by scene."""
import pytest
import torch

from nmcfluid_torch.scenes import get_scene


@pytest.mark.parametrize("name", ["taylorgreen", "karman", "karman2cyl",
                                  "karman3cyl", "jpipe", "smoke",
                                  "smoke_obs", "vortex_collide", "karman3d"])
def test_ramp_width_after_source(name):
    """The ramp width the steps use after add_source: halved in the 2D
    karman family as the JAX CLI does (nmcfluid/run.py:498-500), kept in
    Taylor-Green, jpipe and every 3D scene (karman3d too)."""
    scene = get_scene(name)
    halved = name in ("karman", "karman2cyl", "karman3cyl")
    eps = torch.tensor(scene.bdry_eps)
    assert float(scene.eps_after_source(eps)) == float(
        eps / 2 if halved else eps)
