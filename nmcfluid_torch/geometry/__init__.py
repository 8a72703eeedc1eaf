"""Closed-form boundary queries (the 2D box and channel with circles,
the 3D box), segment and triangle soups with their brute-force queries,
and the obstacles' signed-distance functions."""
from .soup2d import Seg2D, build_segments, polyline_chain, polyline_loop  # noqa: F401
from .soup3d import Tri3D, box_tris, build_triangles  # noqa: F401
from . import queries2d, queries3d  # noqa: F401
