"""2D line-segment soups with silhouette-vertex tables (port of
nmcfluid/geometry/soup2d.py).

A soup is built on the host in numpy (float64) and held as float32
tensors: the segments padded to a multiple of `pad` with slots parked at
FAR (so distance reductions need no masks), each segment's unit normal
n = normalize((d.y, -d.x)) for d = b - a, which points out of the fluid
(fcpw line_segments.inl:46-55), and the silhouette candidates: reflex
vertices (the boundary turns toward the fluid) and open-chain endpoints,
marked `s_always`; convex and flat vertices are dropped, as
Scene::ignoreCandidateSilhouette does (demo/scene.h:84-90).
"""
from typing import NamedTuple

import numpy as np
import torch

FAR = 1.0e6
_SIL_PRECISION = 1e-3


class Seg2D(NamedTuple):
    """Padded segment soup + silhouette vertex table."""
    a: torch.Tensor          # (P, 2) segment start
    b: torch.Tensor          # (P, 2) segment end
    n: torch.Tensor          # (P, 2) unit normal, out of the fluid
    sv: torch.Tensor         # (V, 2) silhouette-candidate vertices
    sn1: torch.Tensor        # (V, 2) normal of the incoming segment
    sn2: torch.Tensor        # (V, 2) normal of the outgoing segment
    s_always: torch.Tensor   # (V,) bool: open-chain endpoint
    bmin: torch.Tensor       # (2,) scene bounding box
    bmax: torch.Tensor       # (2,)

    def to(self, device):
        return Seg2D(*(t.to(device) for t in self))


def _pad_to(arr, m, fill):
    p = (-len(arr)) % m
    if p:
        arr = np.concatenate([arr, np.full((p,) + arr.shape[1:], fill,
                                           dtype=arr.dtype)])
    return arr


def polyline_loop(pts):
    """Closed loop: verts (N, 2) -> segments [(i, i+1 mod N)]."""
    n = len(pts)
    return np.asarray(pts, dtype=np.float64), \
        np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)


def polyline_chain(pts):
    """Open chain: verts (N, 2) -> segments [(i, i+1)]."""
    n = len(pts)
    return np.asarray(pts, dtype=np.float64), \
        np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)


def build_segments(parts, pad: int = 8,
                   double_sided: bool = False) -> Seg2D:
    """Assemble a Seg2D (on the CPU) from [(verts, segs), ...] parts
    (numpy, float64). With d = b - a the normal (d.y, -d.x) must point out
    of the fluid (walls: fluid on the left of d; obstacles clockwise).
    double_sided keeps every interior vertex as a silhouette candidate: a
    vertex convex from one side is reflex from the other, so the static
    drop holds for single-sided problems only (scene.h:84-90)."""
    all_a, all_b, all_n = [], [], []
    sv, sn1, sn2, s_always = [], [], [], []
    for verts, segs in parts:
        verts = np.asarray(verts, dtype=np.float64)
        segs = np.asarray(segs, dtype=np.int64)
        a, b = verts[segs[:, 0]], verts[segs[:, 1]]
        d = b - a
        nrm = np.stack([d[:, 1], -d[:, 0]], axis=1)
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        keep = ln[:, 0] > 1e-12
        a, b, d = a[keep], b[keep], d[keep]
        nrm = nrm[keep] / ln[keep]
        all_a.append(a)
        all_b.append(b)
        all_n.append(nrm)
        # vertex adjacency within this part: seg i ends where seg j starts
        segs = segs[keep]
        n_in, n_out = {}, {}
        for i, (s0, s1) in enumerate(segs):
            n_in.setdefault(s1, []).append(i)
            n_out.setdefault(s0, []).append(i)
        # in the JAX package's order: the set of vertex indices
        for v_idx in set(n_in) | set(n_out):
            ins, outs = n_in.get(v_idx, []), n_out.get(v_idx, [])
            v = verts[v_idx]
            if len(ins) == 1 and len(outs) == 1:
                i, j = ins[0], outs[0]
                d1 = d[i] / np.linalg.norm(d[i])
                d2 = d[j] / np.linalg.norm(d[j])
                turn = d1[0] * d2[1] - d1[1] * d2[0]
                # reflex (turn toward the fluid) <=> turn < 0
                if double_sided or turn < -_SIL_PRECISION:
                    sv.append(v)
                    sn1.append(nrm[i])
                    sn2.append(nrm[j])
                    s_always.append(False)
            elif len(ins) + len(outs) == 1:
                i = (ins + outs)[0]
                sv.append(v)
                sn1.append(nrm[i])
                sn2.append(nrm[i])
                s_always.append(True)

    a = np.concatenate(all_a)
    b = np.concatenate(all_b)
    n = np.concatenate(all_n)
    bmin = np.minimum(a.min(0), b.min(0))
    bmax = np.maximum(a.max(0), b.max(0))
    a = _pad_to(a, pad, FAR)
    b = _pad_to(b, pad, FAR)          # degenerate (a == b) padded segments
    n = _pad_to(n, pad, 0.0)
    if sv:
        sv_, sn1_, sn2_ = np.asarray(sv), np.asarray(sn1), np.asarray(sn2)
        sa_ = np.asarray(s_always, dtype=bool)
    else:
        sv_, sn1_, sn2_ = (np.zeros((0, 2)) for _ in range(3))
        sa_ = np.zeros((0,), dtype=bool)
    sv_ = _pad_to(sv_, pad, FAR)
    sn1_ = _pad_to(sn1_, pad, 0.0)
    sn2_ = _pad_to(sn2_, pad, 0.0)
    sa_ = _pad_to(sa_, pad, False)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    return Seg2D(a=f32(a), b=f32(b), n=f32(n), sv=f32(sv_), sn1=f32(sn1_),
                 sn2=f32(sn2_), s_always=torch.as_tensor(sa_),
                 bmin=f32(bmin), bmax=f32(bmax))


def box_loop(xmin, xmax, ymin, ymax, n_per_side: int = 1):
    """Axis-aligned box traversed counter-clockwise (fluid inside, normals
    outward)."""
    xs = np.linspace(xmin, xmax, n_per_side + 1)
    ys = np.linspace(ymin, ymax, n_per_side + 1)
    pts = ([(x, ymin) for x in xs[:-1]] + [(xmax, y) for y in ys[:-1]]
           + [(x, ymax) for x in xs[::-1][:-1]]
           + [(xmin, y) for y in ys[::-1][:-1]])
    return polyline_loop(np.asarray(pts))


def circle_loop_cw(center, radius, n: int = 40):
    """Circle traversed clockwise (fluid outside, normals toward the
    center)."""
    t = -2.0 * np.pi * np.arange(n) / n
    pts = np.stack([center[0] + radius * np.cos(t),
                    center[1] + radius * np.sin(t)], axis=1)
    return polyline_loop(pts)
