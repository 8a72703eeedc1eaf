"""Image-driven PDE scenes: a boundary OBJ plus PFM/PNG data images (port
of nmcfluid/scenes/images.py).

The zombie demo's primary scene constructor (demo/scene.h:22-52): a
boundary OBJ plus sourceValue / isNeumann / dirichletBoundaryValue /
neumannBoundaryValue images, solved by the mixed-boundary walk
(wost/solver.py). The conventions are the JAX package's:
  * uv = (x - bbox.min) / max(bbox.extent)   (scene.h:80);
  * nearest-cell lookup row = int(uv.y * h), col = int(uv.x * w), both
    clamped (demo/image.h:53-58), on the image in its top-down
    orientation (utils.pfm.read_pfm's);
  * a boundary segment is Neumann iff is_neumann(midpoint uv) > 0.5;
  * 3-channel images collapse to luma (image.h:72-82 setFromRGB).

PNG images need PIL. Where PIL does not import, a PNG path raises
ImportError saying so; PFM images and arrays need nothing.
"""
import numpy as np
import torch

from .. import get_device
from ..geometry.obj_io import read_obj_2d
from ..geometry.soup2d import build_segments
from ..utils.pfm import read_pfm
from ..wost.solver import WostScene

_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def load_gray(path):
    """Grayscale image as a top-down (H, W) float32 array. PFM through
    utils.pfm.read_pfm (already top-down); any other format through PIL,
    scaled to [0, 1] like the reference's stb loader (image.h:166)."""
    p = str(path)
    if p.endswith(".pfm"):
        arr, _ = read_pfm(p)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"load_gray: reading {p!r} needs PIL, which is not "
                "installed; give the image as a .pfm file or an array"
            ) from e
        arr = np.asarray(Image.open(p), np.float32)
        arr = (arr[..., :3] if arr.ndim == 3 else arr) / 255.0
    if arr.ndim == 3:
        arr = arr @ _LUMA
    return np.ascontiguousarray(arr, np.float32)


def image_lookup_fn(arr, bmin, scale):
    """x (..., 2) -> the nearest-cell image value under the demo's uv map,
    on x's device."""
    img = torch.as_tensor(np.asarray(arr, np.float32))
    h, w = arr.shape
    lo = torch.as_tensor(np.asarray(bmin, np.float32))
    on = {}

    def fn(x, *_):
        dev = x.device
        if dev not in on:
            on[dev] = (img.to(dev), lo.to(dev))
        im, lo_d = on[dev]
        uv = (x - lo_d) / scale
        j = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
        i = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
        return im[i, j]
    return fn


def scene_from_images(boundary_obj, *, source=None, dirichlet_value=None,
                      neumann_value=None, is_neumann=None, absorption=0.0,
                      flip_orientation=True, normalize=False, device=None):
    """A mixed-boundary WostScene from a 2D boundary OBJ and data images.

    Each image is a path (pfm, or png with PIL) or an (H, W) array; None
    means zero data (is_neumann None: all Neumann). flip_orientation
    reverses every segment (scene.h:119-126, the demo's default);
    normalize recenters to the unit disk (scene.h:132-143). The default
    sigma is 0: the harmonic walk. The soups are built on `device`: the
    card by default (RuntimeError without one), the CPU when asked.

    Returns (scene, meta) with meta = dict(bmin, bmax, scale, verts, segs,
    is_neumann_seg)."""
    device = get_device(device)
    verts, segs = read_obj_2d(boundary_obj)
    verts = np.asarray(verts, np.float64)
    segs = np.asarray(segs, np.int64)
    if flip_orientation:
        segs = segs[:, ::-1]
    if normalize:
        verts = verts - verts.mean(0)
        verts = verts / np.linalg.norm(verts, axis=1).max()
    bmin, bmax = verts.min(0), verts.max(0)
    scale = float((bmax - bmin).max())

    def _load(im):
        if im is None:
            return None
        return im if isinstance(im, np.ndarray) else load_gray(im)

    def _host_lookup(arr, pts):
        uv = (pts - bmin) / scale
        h, w = arr.shape
        j = np.clip((uv[:, 0] * w).astype(int), 0, w - 1)
        i = np.clip((uv[:, 1] * h).astype(int), 0, h - 1)
        return arr[i, j]

    isn = _load(is_neumann)
    if isn is None:
        neu_mask = np.ones(len(segs), bool)
    else:
        mid = 0.5 * (verts[segs[:, 0]] + verts[segs[:, 1]])
        neu_mask = _host_lookup(isn, mid) > 0.5

    neu_segs = segs[neu_mask]
    dir_segs = segs[~neu_mask]
    if len(neu_segs) == 0:
        raise ValueError("scene_from_images needs at least one Neumann "
                         "segment (the estimator's star geometry is the "
                         "Neumann soup)")
    neumann = build_segments([(verts, neu_segs)]).to(device)
    dirichlet = (build_segments([(verts, dir_segs)]).to(device)
                 if len(dir_segs) else None)

    src = _load(source)
    dbv = _load(dirichlet_value)
    nbv = _load(neumann_value)

    def zero(x, *_):
        return torch.zeros(x.shape[:-1], dtype=torch.float32,
                           device=x.device)

    scene = WostScene(
        dim=2, neumann=neumann,
        source_fn=(image_lookup_fn(src, bmin, scale) if src is not None
                   else zero),
        absorption=float(absorption),
        dirichlet=dirichlet,
        dirichlet_fn=(image_lookup_fn(dbv, bmin, scale)
                      if dbv is not None and dirichlet is not None
                      else None),
        neumann_fn=(image_lookup_fn(nbv, bmin, scale)
                    if nbv is not None else None))
    meta = dict(bmin=bmin, bmax=bmax, scale=scale, verts=verts, segs=segs,
                is_neumann_seg=neu_mask)
    return scene, meta
