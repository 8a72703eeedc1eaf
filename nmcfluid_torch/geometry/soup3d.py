"""3D triangle soups with silhouette-edge tables (port of
nmcfluid/geometry/soup3d.py).

A soup is built on the host in numpy (float64) and held as float32
tensors: the triangles, degenerate faces dropped, padded to a multiple of
`pad` with zero-area slots parked at FAR (so distance reductions need no
masks), each face's unit normal n = normalize((b - a) x (c - a)), which
points out of the fluid, and the silhouette candidates: interior edges
whose dihedral bends toward the fluid (reflex) and the boundary edges of
open meshes, marked `e_always`. A closed convex mesh (the cube) has an
empty table, so its star radii are the caller's cap.
"""
from typing import NamedTuple

import numpy as np
import torch

from .soup2d import _pad_to

FAR = 1.0e6
_SIL_PRECISION = 1e-3


class Tri3D(NamedTuple):
    """Padded triangle soup + silhouette edge table."""
    va: torch.Tensor         # (P, 3)
    vb: torch.Tensor         # (P, 3)
    vc: torch.Tensor         # (P, 3)
    n: torch.Tensor          # (P, 3) unit normal, out of the fluid
    ea: torch.Tensor         # (E, 3) silhouette-candidate edge start
    eb: torch.Tensor         # (E, 3) silhouette-candidate edge end
    en1: torch.Tensor        # (E, 3) normals of the two adjacent faces
    en2: torch.Tensor        # (E, 3)
    e_always: torch.Tensor   # (E,) bool: open-boundary edge
    bmin: torch.Tensor       # (3,) scene bounding box
    bmax: torch.Tensor       # (3,)

    def to(self, device):
        return Tri3D(*(t.to(device) for t in self))


def build_triangles(verts, faces, pad: int = 8) -> Tri3D:
    """Assemble a Tri3D (on the CPU) from verts (V, 3) and faces (F, 3),
    wound so that (b - a) x (c - a) points out of the fluid."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    va, vb, vc = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(vb - va, vc - va)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    keep = ln[:, 0] > 1e-14
    va, vb, vc = va[keep], vb[keep], vc[keep]
    n = n[keep] / ln[keep]
    faces = faces[keep]

    # edge adjacency: sorted vertex pair -> [(face, oriented?), ...]
    edges = {}
    for fi, f in enumerate(faces):
        for k in range(3):
            i, j = int(f[k]), int(f[(k + 1) % 3])
            edges.setdefault((min(i, j), max(i, j)), []).append((fi, i < j))
    ea, eb, en1, en2, e_always = [], [], [], [], []
    for (i, j), adj in edges.items():
        if len(adj) == 1:
            fi = adj[0][0]
            ea.append(verts[i])
            eb.append(verts[j])
            en1.append(n[fi])
            en2.append(n[fi])
            e_always.append(True)
        elif len(adj) == 2:
            f1, f2 = adj[0][0], adj[1][0]
            # reflex: the far vertex of face 2 lies on the outward side of
            # face 1, so the edge bends toward the fluid
            far2 = [v for v in faces[f2] if v not in (i, j)][0]
            h = float(np.dot(verts[far2] - verts[i], n[f1]))
            if h > _SIL_PRECISION * max(1.0, np.linalg.norm(verts[j]
                                                             - verts[i])):
                ea.append(verts[i])
                eb.append(verts[j])
                en1.append(n[f1])
                en2.append(n[f2])
                e_always.append(False)

    bmin, bmax = verts.min(0), verts.max(0)
    va = _pad_to(va, pad, FAR)
    vb = _pad_to(vb, pad, FAR)          # zero-area padded slots
    vc = _pad_to(vc, pad, FAR)
    n = _pad_to(n, pad, 0.0)
    if ea:
        ea_, eb_ = np.asarray(ea), np.asarray(eb)
        en1_, en2_ = np.asarray(en1), np.asarray(en2)
        eal_ = np.asarray(e_always, dtype=bool)
    else:
        ea_, eb_, en1_, en2_ = (np.zeros((0, 3)) for _ in range(4))
        eal_ = np.zeros((0,), dtype=bool)
    ea_ = _pad_to(ea_, pad, FAR)
    eb_ = _pad_to(eb_, pad, FAR)
    en1_ = _pad_to(en1_, pad, 0.0)
    en2_ = _pad_to(en2_, pad, 0.0)
    eal_ = _pad_to(eal_, pad, False)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    return Tri3D(va=f32(va), vb=f32(vb), vc=f32(vc), n=f32(n), ea=f32(ea_),
                 eb=f32(eb_), en1=f32(en1_), en2=f32(en2_),
                 e_always=torch.as_tensor(eal_), bmin=f32(bmin),
                 bmax=f32(bmax))


def box_tris(bmin, bmax):
    """Axis-aligned box as 12 triangles, normals outward (fluid inside):
    (verts (8, 3), faces (12, 3)), the z walls first, then y, then x."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
    f = np.array([
        [0, 2, 1], [0, 3, 2],          # z = z0, normal -z
        [4, 5, 6], [4, 6, 7],          # z = z1, normal +z
        [0, 1, 5], [0, 5, 4],          # y = y0, normal -y
        [3, 7, 6], [3, 6, 2],          # y = y1, normal +y
        [0, 4, 7], [0, 7, 3],          # x = x0, normal -x
        [1, 2, 6], [1, 6, 5],          # x = x1, normal +x
    ])
    return v, f
