"""Orthographic volume renders of exported 3D density grids (port of
nmcfluid/tools_render_density3d.py; numpy only).

`python -m nmcfluid_torch.tools_render_density3d EXPDIR [--frames 1 25 65
100 160] [--axis 1]` reads `EXPDIR/density/density_tNNN.npz` (written by
`run.py --density` on 3D scenes: arrays `density` (N,N,N) and optional
`Cd` (N,N,N,3) ring colors, move_density.py:112-116) and writes
`EXPDIR/render/density_tNNN.png` via front-to-back alpha compositing along
a view axis — the stand-in for the reference's Blender renders of the same
contents (final_material/vortex_collide/*.png). Drawing needs matplotlib,
and --gif also PIL: where either is missing the command is refused at
parsing.
"""
import argparse
import os
import re

import numpy as np

from .utils.vis import have_matplotlib


def composite(rho, color, axis=1, absorb=60.0, bg=1.0):
    """Front-to-back alpha compositing. rho (N,N,N) >= 0, color
    broadcastable to (N,N,N,3); returns (H,W,3) in [0,1]."""
    rho = np.moveaxis(rho, axis, 0)
    color = np.moveaxis(color, axis, 0)
    dz = 1.0 / rho.shape[0]
    alpha = 1.0 - np.exp(-absorb * np.clip(rho, 0.0, None) * dz)
    # transmittance BEFORE each slab
    trans = np.cumprod(1.0 - alpha, axis=0)
    trans = np.concatenate([np.ones_like(trans[:1]), trans[:-1]], axis=0)
    w = (trans * alpha)[..., None]
    img = np.sum(w * color, axis=0)
    t_total = trans[-1] * (1.0 - alpha[-1])
    return img + t_total[..., None] * bg


def _have_pil():
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("expdir")
    ap.add_argument("--frames", type=int, nargs="*",
                    default=[1, 25, 65, 100, 160])
    ap.add_argument("--axis", type=int, default=1,
                    help="view axis to integrate along")
    ap.add_argument("--absorb", type=float, default=60.0)
    ap.add_argument("--smoke_gray", type=float, default=0.35,
                    help="albedo for scenes without Cd colors; must differ "
                         "from the white background or the composite is "
                         "identically bg (sum(w*c) + T*bg == 1 when c == bg)")
    ap.add_argument("--deficit", action="store_true",
                    help="render max(rho)-rho instead of rho: for scenes "
                         "whose density IC is near-uniform dye (karman3d), "
                         "the flow signature is the dye DEFICIT the wake "
                         "carves out, not the dye itself")
    ap.add_argument("--gif", metavar="OUT.gif", default=None,
                    help="also assemble the rendered frames (in --frames "
                         "order) into an animated gif")
    ap.add_argument("--every", type=int, default=0, metavar="K",
                    help="instead of --frames, render every Kth frame "
                         "present in EXPDIR/density/")
    ap.add_argument("--fps", type=int, default=10)
    args = ap.parse_args(argv)
    if not have_matplotlib():
        ap.error("rendering needs matplotlib, which is not installed")
    if args.gif and not _have_pil():
        ap.error("--gif needs PIL, which is not installed")
    from .utils.vis import _plt
    plt = _plt()

    out_dir = os.path.join(args.expdir, "render")
    os.makedirs(out_dir, exist_ok=True)
    frames = args.frames
    if args.every:
        avail = sorted(
            int(m.group(1))
            for f in os.listdir(os.path.join(args.expdir, "density"))
            if (m := re.match(r"density_t(\d+)\.npz$", f)))
        frames = avail[::args.every]
    gif_frames = []
    for t in frames:
        path = os.path.join(args.expdir, "density",
                            f"density_t{t:03d}.npz")
        if not os.path.exists(path):
            print(f"skip t={t}: {path} missing")
            continue
        with np.load(path) as z:
            rho = z["density"]
            col = z["Cd"] if "Cd" in z.files else None
        if args.deficit:
            rho = float(rho.max()) - rho
        if col is None:
            # gray smoke on the white background, like the reference's
            # Blender plume renders (final_material/smoke_plume/plume*.png)
            col = np.full(rho.shape + (3,), args.smoke_gray, np.float32)
        img = composite(rho, col, axis=args.axis, absorb=args.absorb)
        img = np.clip(np.rot90(img), 0.0, 1.0)
        out = os.path.join(out_dir, f"density_t{t:03d}.png")
        plt.imsave(out, img)
        print("wrote", out)
        if args.gif:
            gif_frames.append((img * 255).astype(np.uint8))
    if args.gif and gif_frames:
        from PIL import Image
        ims = [Image.fromarray(f) for f in gif_frames]
        ims[0].save(args.gif, save_all=True, append_images=ims[1:],
                    duration=max(1, 1000 // args.fps), loop=0)
        print("wrote", args.gif, f"({len(ims)} frames)")


if __name__ == "__main__":
    main()
