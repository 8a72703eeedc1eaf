"""Quantitative vortex-street metrics for a 3D karman run (port of
nmcfluid/tools_street3d.py).

`python -m nmcfluid_torch.tools_street3d EXP [--scene karman3d] [--out png]
[--device cpu]`

The reference validates karman3d qualitatively only (volume renders of
the advected density, final_material/karman_3d); this measures the
shedding physics instead, like `tools_compare_street` does in 2D: the
transverse velocity u_x at a probe 6 radii downstream of the cylinder
(on the wake centerline, mid-span y=0), for every checkpoint, then
onset frame + dominant frequency as a Strouhal number St = f D / U.
The 2D street uses probe *vorticity*; in 3D the transverse velocity
component is the standard shedding signal (one scalar, no curl stencil).
Cheap (one SIREN evaluation per checkpoint): `--device cpu` is enough.
"""
import json

import numpy as np
import torch

from .scenes import get_scene
from .tools_compare_street import (checkpoint_params, parse_plot_args,
                                   plot_parser, street_metrics)


def probe_series_vel(exp_dir, scene, probes, comp=0, t_max=None,
                     device=None):
    """Velocity component `comp` at probe points per checkpoint -> (T, P)."""
    fluid, st, runs = checkpoint_params(exp_dir, scene, t_max, device)
    pts = torch.tensor(probes, dtype=torch.float32, device=fluid.device)
    out = []
    with torch.no_grad():
        for t, params in runs:
            u = fluid.velocity(params, pts, eps=st.eps, t=t)
            out.append(u[:, comp].cpu().numpy())
    return np.stack(out)


def main(argv=None):
    p = plot_parser()
    p.add_argument("exp")
    p.add_argument("--scene", default="karman3d")
    args = parse_plot_args(p, argv)

    scene = get_scene(args.scene)
    if scene.dim != 3:
        p.error("use tools_compare_street for 2D scenes")
    # karman3d: cylinder axis || y at (x, z) = (0, -0.8), r = 0.1
    # (src/3d/main.py:92-94); inflow +z at karman_vel. Probe 6 radii
    # downstream on the centerline at mid-span; shedding = u_x.
    cx, cz = 0.0, -0.8
    r = 0.1
    probes = [(cx, 0.0, cz + 6.0 * r)]
    d, u = 2.0 * r, scene.karman_vel

    s = probe_series_vel(args.exp, scene, probes, comp=0,
                         t_max=args.t_max, device=args.device)[:, 0]
    m = street_metrics(s, scene.dt, d, u)
    m["exp"] = args.exp
    print(json.dumps(m))

    if args.out:
        from .utils.vis import _plt
        plt = _plt()
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(np.arange(1, len(s) + 1) * scene.dt, s)
        if m["onset_frame"] is not None:
            ax.axvline((m["onset_frame"] + 1) * scene.dt, ls="--", c="gray")
        ax.set_xlabel("t")
        ax.set_ylabel("u_x at probe")
        st_txt = (f"St = {m['strouhal']:.4f}" if m["strouhal"]
                  else "no developed street")
        ax.set_title(f"{args.scene} probe u_x — {st_txt}")
        fig.tight_layout()
        fig.savefig(args.out, dpi=150)
        plt.close(fig)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
