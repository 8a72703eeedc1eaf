"""Portable FloatMap (PFM) IO, the reference's float-image interchange
format (demo/image.h:100-216; WoSt debug grids and the divergence
magnitude images are PFMs). A copy of nmcfluid/utils/pfm.py: numpy
only."""
import numpy as np


def write_pfm(path, arr, scale=1.0):
    """arr: (H, W) or (H, W, 3) float32. Little-endian (negative scale)."""
    a = np.asarray(arr, np.float32)
    color = a.ndim == 3 and a.shape[2] == 3
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[2] not in (1, 3):
        raise ValueError(f"PFM needs 1 or 3 channels, got {a.shape[2]}")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{a.shape[1]} {a.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        # PFM rows are bottom-to-top
        f.write(np.flipud(a[..., 0] if not color else a).astype(
            "<f4").tobytes())


def read_pfm(path):
    """Returns (arr (H, W) or (H, W, 3), scale)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {header!r}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dt = "<f4" if scale < 0 else ">f4"
        n = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(n * 4), dtype=dt).astype(np.float32)
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)
