"""User scenes from 2D line OBJs and 3D triangle OBJs (port of
nmcfluid/scenes/custom.py).

In 2D, as src/2d/main.py:36-59 does with its boundary file: measure the
bbox, split the boundary segments into outer walls and interior obstacle
loops (a segment is an obstacle's if either endpoint lies strictly inside
the bbox), and derive the obstacles' signed distance: the exact polygon
SDF (crossing-number sign times the distance to the segments, positive in
the fluid) where the reference fits a circle (main.py:95-103). In 3D the
bbox gives the scene size and the faces one triangle soup, with no
obstacle SDF.

The scene walks its whole boundary as one soup. Its hard boundary
conditions are chosen by name (models/boundary.py), so it steps under
the fluid only when it takes a catalog scene's name, as in the JAX
package; `base` gives every other setting, whatever its dimension.
"""
import dataclasses

import numpy as np
import torch

from ..geometry.obj_io import read_obj_2d, read_obj_3d
from ..geometry.soup2d import build_segments
from ..geometry.soup3d import build_triangles
from .specs import SCENES


def polygon_sdf(verts, segs):
    """sdf(x) > 0 outside the polygon soup (the fluid side), < 0 inside:
    crossing-number sign times the unsigned distance to the segments
    (the gpytoolbox winding-number SDF of src/2d/sources.py:102-119)."""
    a0 = torch.as_tensor(np.asarray(verts[segs[:, 0]], np.float32))
    b0 = torch.as_tensor(np.asarray(verts[segs[:, 1]], np.float32))
    on = {}

    def f(x):
        if x.device not in on:
            on[x.device] = (a0.to(x.device), b0.to(x.device))
        a, b = on[x.device]
        ab = b - a
        xa = x[..., None, :] - a
        t = torch.clamp(torch.sum(xa * ab, -1)
                        / torch.clamp(torch.sum(ab * ab, -1), min=1e-20),
                        0.0, 1.0)
        d = torch.linalg.vector_norm(xa - t[..., None] * ab, dim=-1)
        dist = torch.amin(d, dim=-1)
        # crossing number along +x
        ya, yb = a[:, 1], b[:, 1]
        y = x[..., None, 1]
        cond = ((ya <= y) & (yb > y)) | ((yb <= y) & (ya > y))
        xs = a[:, 0] + (y - ya) / torch.where(
            torch.abs(yb - ya) < 1e-20, 1.0, yb - ya) * (b[:, 0] - a[:, 0])
        crossings = torch.sum(cond & (xs > x[..., None, 0]), dim=-1)
        inside = torch.remainder(crossings, 2) == 1
        return torch.where(inside, -dist, dist)
    return f


def scene_from_obj(name, obj_path, dim=2, source_builder=None,
                   base="karman", **overrides):
    """A SceneSpec whose boundary comes from an OBJ: 2D lines (dim=2) or
    3D faces, fan-triangulated (dim=3). `base` picks the hyperparameter
    defaults from the catalog; `source_builder(spec, x, key)` -> velocity
    defaults to zero inflow."""
    tmpl = SCENES[base]
    sdf_builder = None
    if dim == 2:
        verts, segs = read_obj_2d(obj_path)
        mn, mx = verts.min(0), verts.max(0)
        scene_size = (float(mn[0]), float(mx[0]), float(mn[1]),
                      float(mx[1]))
        strict_in = ((verts > mn + 1e-12) & (verts < mx - 1e-12)).all(1)
        obs_mask = strict_in[segs[:, 0]] | strict_in[segs[:, 1]]
        obs_segs = segs[obs_mask]
        soup = build_segments([(verts, segs)])
        if len(obs_segs):
            sdf = polygon_sdf(verts, obs_segs)

            def sdf_builder(spec):
                return sdf
    else:
        verts, faces = read_obj_3d(obj_path)
        mn, mx = verts.min(0), verts.max(0)
        scene_size = tuple(float(v) for pair in zip(mn, mx) for v in pair)
        soup = build_triangles(verts, faces)

    def zero_source(spec, x, key):
        return torch.zeros(x.shape[:-1] + (dim,), dtype=torch.float32,
                           device=x.device)

    return dataclasses.replace(
        tmpl, name=name, dim=dim, scene_size=scene_size,
        _boundary_builder=lambda spec: soup,
        _obstacle_sdf_builder=sdf_builder,
        _source_builder=source_builder or zero_source, **overrides)
