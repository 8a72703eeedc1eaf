"""Wavefront OBJ ingestion for user geometry (a copy of
nmcfluid/geometry/obj_io.py: numpy only).

Covers the reference's two OBJ dialects: 2D line OBJs (`v x y` + `l i j`,
read by src/2d/main.py:17-34 and demo/scene.h:104-145) and 3D triangle
OBJs (`v x y z` + `f ...`, read via gpytoolbox in src/3d/main.py). The
shipped scenes are generated procedurally in the scene catalog; this
module reads externally authored geometry.
"""
import numpy as np


def read_obj_2d(path):
    """Returns (verts (N,2) float64, segments (M,2) int64)."""
    v, l = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                v.append([float(p[1]), float(p[2])])
            elif p[0] == "l":
                idx = [int(t.split("/")[0]) - 1 for t in p[1:]]
                for i in range(len(idx) - 1):
                    l.append([idx[i], idx[i + 1]])
    return np.asarray(v, dtype=np.float64), np.asarray(l, dtype=np.int64)


def read_obj_3d(path):
    """Returns (verts (N,3) float64, faces (M,3) int64), fan-triangulated."""
    v, f = [], []
    with open(path) as fh:
        for line in fh:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                v.append([float(p[1]), float(p[2]), float(p[3])])
            elif p[0] == "f":
                idx = [int(t.split("/")[0]) - 1 for t in p[1:]]
                for i in range(1, len(idx) - 1):
                    f.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(v, dtype=np.float64), np.asarray(f, dtype=np.int64)


def write_obj_2d(path, verts, segs):
    with open(path, "w") as f:
        for x, y in verts:
            f.write(f"v {x} {y} 0.0\n")
        for a, b in segs:
            f.write(f"l {a + 1} {b + 1}\n")


def write_obj_3d(path, verts, faces):
    with open(path, "w") as f:
        for x, y, z in verts:
            f.write(f"v {x} {y} {z}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")
