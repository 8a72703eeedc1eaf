"""SVG path -> 2D line-OBJ conversion (dependency-free; a copy of
nmcfluid/geometry/svg.py: numpy only).

Replaces src/3d/wost/svg2obj.py, which shells through svgpathtools +
shapely (neither is in this image). Parses the `d` attribute subset the
reference assets actually use — M/m, L/l, H/h, V/v, C/c, Q/q, Z/z — and
flattens curves into fixed-count polylines.

`python -m nmcfluid_torch.geometry.svg in.svg out.obj [--samples 20]
[--scale S]`
"""
import argparse
import re
import xml.etree.ElementTree as ET

import numpy as np

_TOKEN = re.compile(r"[MmLlHhVvCcQqZz]|-?\d*\.?\d+(?:[eE][-+]?\d+)?")


def _cubic(p0, p1, p2, p3, n):
    t = np.linspace(0.0, 1.0, n + 1)[1:, None]
    return ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * p1
            + 3 * (1 - t) * t ** 2 * p2 + t ** 3 * p3)


def _quad(p0, p1, p2, n):
    t = np.linspace(0.0, 1.0, n + 1)[1:, None]
    return (1 - t) ** 2 * p0 + 2 * (1 - t) * t * p1 + t ** 2 * p2


def parse_path(d, samples=20):
    """Parse one `d` string into a list of polylines (each (N, 2))."""
    toks = _TOKEN.findall(d)
    i = 0
    cur = np.zeros(2)
    start = np.zeros(2)
    cmd = None
    polys, pts = [], []

    def num():
        nonlocal i
        v = float(toks[i])
        i += 1
        return v

    def pt(rel):
        p = np.array([num(), num()])
        return cur + p if rel else p

    while i < len(toks):
        if toks[i].isalpha():
            cmd = toks[i]
            i += 1
            if cmd in "Zz":
                if pts:
                    pts.append(start.copy())
                    polys.append(np.asarray(pts))
                    pts = []
                cur = start.copy()
                continue
        rel = cmd.islower()
        c = cmd.upper()
        if c == "M":
            if pts:
                polys.append(np.asarray(pts))
            cur = pt(rel)
            start = cur.copy()
            pts = [cur.copy()]
            cmd = "l" if rel else "L"   # subsequent pairs are line-tos
        elif c == "L":
            cur = pt(rel)
            pts.append(cur.copy())
        elif c == "H":
            x = num()
            cur = np.array([cur[0] + x if rel else x, cur[1]])
            pts.append(cur.copy())
        elif c == "V":
            y = num()
            cur = np.array([cur[0], cur[1] + y if rel else y])
            pts.append(cur.copy())
        elif c == "C":
            p1, p2, p3 = pt(rel), pt(rel), pt(rel)
            pts.extend(_cubic(cur, p1, p2, p3, samples))
            cur = p3
        elif c == "Q":
            p1, p2 = pt(rel), pt(rel)
            pts.extend(_quad(cur, p1, p2, samples))
            cur = p2
        else:
            raise ValueError(f"unsupported SVG path command {cmd!r}")
    if pts:
        polys.append(np.asarray(pts))
    return polys


def svg_to_parts(svg_path, samples=20, scale=1.0, flip_y=True):
    """All <path>/<line>/<rect> elements -> [(verts, segs), ...] parts for
    geometry/soup2d.py's build_segments. SVG y points down; flip_y
    restores the right-handed convention the solver uses."""
    from .soup2d import polyline_chain, polyline_loop
    root = ET.parse(svg_path).getroot()
    ns = {"svg": "http://www.w3.org/2000/svg"}
    parts = []

    def add_poly(p, closed):
        p = np.asarray(p, dtype=np.float64) * scale
        if flip_y:
            p = p * np.array([1.0, -1.0])
        if closed or np.allclose(p[0], p[-1]):
            q = p[:-1] if np.allclose(p[0], p[-1]) else p
            parts.append(polyline_loop(q))
        else:
            parts.append(polyline_chain(p))

    for el in root.iter():
        tag = el.tag.split("}")[-1]
        if tag == "path":
            for poly in parse_path(el.get("d", ""), samples):
                if len(poly) >= 2:
                    add_poly(poly, False)
        elif tag == "line":
            add_poly([[float(el.get("x1")), float(el.get("y1"))],
                      [float(el.get("x2")), float(el.get("y2"))]], False)
        elif tag == "rect":
            x, y = float(el.get("x", 0)), float(el.get("y", 0))
            w, h = float(el.get("width")), float(el.get("height"))
            add_poly([[x, y], [x + w, y], [x + w, y + h], [x, y + h]], True)
    return parts


def main(argv=None):
    from .obj_io import write_obj_2d
    ap = argparse.ArgumentParser()
    ap.add_argument("svg")
    ap.add_argument("obj")
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    parts = svg_to_parts(args.svg, args.samples, args.scale)
    verts, segs = [], []
    off = 0
    for v, s in parts:
        verts.extend(v.tolist())
        segs.extend((np.asarray(s) + off).tolist())
        off += len(v)
    write_obj_2d(args.obj, verts, segs)
    print(f"wrote {args.obj}: {len(verts)} verts, {len(segs)} segments")


if __name__ == "__main__":
    main()
