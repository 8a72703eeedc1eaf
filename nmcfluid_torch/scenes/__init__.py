"""Scene catalog: Taylor-Green, the karman family and the 3D scenes."""
from .specs import (SCENES, UNPORTED_SCENES, SceneSpec,  # noqa: F401
                    get_scene)
