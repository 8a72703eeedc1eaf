"""Scene catalog: Taylor-Green, the karman family, jpipe and the 3D
scenes."""
from .specs import SCENES, SceneSpec, get_scene  # noqa: F401
