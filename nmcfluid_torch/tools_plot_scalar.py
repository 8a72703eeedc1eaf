"""Karman vorticity txt -> png renderer (port of
nmcfluid/tools_plot_scalar.py).

`python -m nmcfluid_torch.tools_plot_scalar <txt_dir> <resolution>`

Rebuild of examples/karman/plot_scalar.py:25-39: read the per-frame
vorticity txt dumps written by the simulation, zero |w| < 0.3, and render a
bwr colormap image per frame. Needs matplotlib: where it is missing the
command exits with a message before reading anything.
"""
import os
import sys

import numpy as np

from .utils import vis


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit("usage: tools_plot_scalar <txt_dir> [resolution]")
    if not vis.have_matplotlib():
        raise SystemExit("tools_plot_scalar: rendering needs matplotlib, "
                         "which is not installed")
    txt_dir = argv[0]
    res = int(argv[1]) if len(argv) > 1 else 1000
    out_dir = os.path.join(os.path.dirname(txt_dir.rstrip("/")),
                           "vorticity_clean")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(txt_dir)):
        if not (f.startswith("vorticity_values") and f.endswith(".txt")):
            continue
        w = np.loadtxt(os.path.join(txt_dir, f)).reshape(res, -1)
        w[np.abs(w) < 0.3] = 0.0       # plot_scalar.py:25-39
        name = f.replace("values", "clean").replace(".txt", ".png")
        vis.draw_scalar_field2d(w, os.path.join(out_dir, name),
                                vmin=-5, vmax=5)
        n += 1
    print(f"rendered {n} frames -> {out_dir}")


if __name__ == "__main__":
    main()
