"""Scene catalog (Taylor-Green only so far)."""
from .specs import SCENES, SceneSpec, get_scene  # noqa: F401
