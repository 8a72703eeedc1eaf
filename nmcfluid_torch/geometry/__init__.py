"""Closed-form boundary queries (the 2D box and channel with circles,
the 3D box) and the obstacles' signed-distance functions."""
