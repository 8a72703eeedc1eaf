"""Device lists for walking the pressure points on several devices."""
from .mesh import points_mesh, replicate, shard_points  # noqa: F401
