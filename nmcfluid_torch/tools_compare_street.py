"""Quantitative vortex-street comparison between two karman runs (port of
nmcfluid/tools_compare_street.py).

`python -m nmcfluid_torch.tools_compare_street EXP_A EXP_B [--scene karman]
[--device cpu]`

The reference validates karman qualitatively (vorticity plots,
examples/karman/plot_scalar.py); chaotic trajectories make frame-wise
field comparison meaningless after street onset, so this compares the
physics instead: probe-point vorticity time series behind the cylinder,
street onset time (first sustained asymmetry), and the dominant shedding
frequency as a Strouhal number St = f D / U. The checkpoints may come from
either package. `--out` draws a png and needs matplotlib (refused at
parsing where it is missing).
"""
import argparse
import json
import os

import numpy as np
import torch

from .ops.diff_ops import curl2d
from .scenes import get_scene
from .sim.fluid import NeuralFluid
from .utils.checkpoint import latest_step, load_ckpt
from .utils.keys import Key
from .utils.vis import have_matplotlib


def checkpoint_params(exp_dir, scene, t_max=None, device=None):
    """The fluid of `scene` on `device` (its hard BCs keyed as the CLI
    keys them), its initial state, and an iterator of (t, params) over the
    run's checkpoints 1..last (or t_max)."""
    fluid = NeuralFluid(scene, max_n_iters=1, device=device)
    model_dir = os.path.join(exp_dir, "model")
    last = latest_step(model_dir)
    if last < 0:
        raise SystemExit(f"no checkpoints under {model_dir}")
    if t_max is not None:
        last = min(last, t_max)
    st = fluid.init_state(key=Key.from_seed(0))
    return fluid, st, ((t, load_ckpt(model_dir, st.params, t)[0])
                       for t in range(1, last + 1))


def probe_series(exp_dir, scene, probes, t_max=None, device=None):
    """Vorticity at probe points for every checkpoint -> (T, P) array."""
    fluid, st, runs = checkpoint_params(exp_dir, scene, t_max, device)
    pts = torch.tensor(probes, dtype=torch.float32, device=fluid.device)
    out = []
    for t, params in runs:
        w = curl2d(lambda x: fluid.velocity(params, x, eps=st.eps, t=t),
                   pts)
        out.append(w.cpu().numpy())
    return np.stack(out)


def street_metrics(series, dt, diameter, u_inflow, onset_rel=0.35):
    """Onset frame + dominant shedding frequency of a probe series.

    The raw probe signal carries a startup transient (the initial shear
    layer convecting past the probe) and a quasi-steady wake offset;
    neither is shedding. So the signal is first detrended with a rolling
    mean (~2 shedding periods wide), and onset is defined on the rolling
    std of the detrended signal: the start of the final run of frames, the
    one reaching the end of the series, over which that local oscillation
    amplitude stays above onset_rel * its developed (last third) level
    (at least 10 frames). An oscillatory startup transient that crosses
    the threshold and dies back down is thereby skipped. The shedding
    frequency is the FFT peak of the detrended tail from onset, refined by
    a parabolic fit of the log-magnitude peak; St = f D / U."""
    w = np.asarray(series, np.float64)
    n = len(w)
    trend_win = 24                 # ~2 shedding periods at St~0.2 scales
    kern = np.ones(trend_win) / trend_win
    pad = trend_win // 2
    trend = np.convolve(np.pad(w, pad, mode="edge"), kern, mode="same")[
        pad:pad + n]
    hp = w - trend
    osc_win = 12
    amp = np.array([hp[t:t + osc_win].std() for t in range(n)])
    developed = amp[2 * n // 3:].mean()
    thresh = onset_rel * developed
    onset = None
    above = amp > thresh
    valid = n - osc_win        # amp[t] uses hp[t:t+osc_win]; beyond this
    if valid > 10 and above[valid - 10:valid].all():  # the window shrinks
        t = valid - 10
        while t > 0 and above[t - 1]:
            t -= 1
        onset = t
    # reject "onset" when there is no developed oscillation at all
    # (quiet run: the tail level is numerical noise)
    if developed < 1e-4 * max(np.abs(w).max(), 1e-12):
        onset = None
    if onset is None or n - onset < 16:
        return {"onset_frame": onset, "freq_hz": None, "strouhal": None}
    tail = hp[onset:]
    tail = tail - tail.mean()
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    freqs = np.fft.rfftfreq(len(tail), d=dt)
    k = 1 + int(np.argmax(spec[1:]))          # skip DC
    f = freqs[k]
    if 1 <= k < len(spec) - 1 and spec[k] > 0:
        a, b, c = (np.log(max(spec[k - 1], 1e-300)),
                   np.log(spec[k]),
                   np.log(max(spec[k + 1], 1e-300)))
        denom = a - 2 * b + c
        if denom < 0:
            f = freqs[k] + 0.5 * (a - c) / denom * (freqs[1] - freqs[0])
    return {"onset_frame": onset,
            "freq_hz": float(f),
            "strouhal": float(f * diameter / u_inflow)}


def plot_parser(description=None):
    """An argument parser whose --out png is refused at parsing where
    matplotlib is missing, with --t_max and --device."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--t_max", type=int, default=None)
    p.add_argument("--out", default=None, help="optional png path")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card, and an error "
                        "without one); 'cpu' runs on the CPU")
    return p


def parse_plot_args(p, argv):
    args = p.parse_args(argv)
    if args.out and not have_matplotlib():
        p.error("--out draws a png and needs matplotlib, which is not "
                "installed")
    return args


def main(argv=None):
    p = plot_parser()
    p.add_argument("exp_a")
    p.add_argument("exp_b")
    p.add_argument("--scene", default="karman")
    args = parse_plot_args(p, argv)

    scene = get_scene(args.scene)
    cx, cy = scene.obstacle_center
    r = scene.obstacle_radius
    # probe 6 radii downstream of the cylinder, on the wake centerline
    probes = [(cx + 6.0 * r, cy)]
    d, u = 2.0 * r, scene.karman_vel

    results = {}
    for name, exp in (("a", args.exp_a), ("b", args.exp_b)):
        s = probe_series(exp, scene, probes, args.t_max, args.device)[:, 0]
        m = street_metrics(s, scene.dt, d, u)
        m["exp"] = exp
        results[name] = (s, m)
        print(json.dumps(m))

    if args.out:
        from .utils.vis import _plt
        plt = _plt()
        fig, ax = plt.subplots(figsize=(8, 3))
        for name, (s, m) in results.items():
            ax.plot(np.arange(1, len(s) + 1) * scene.dt, s,
                    label=f"{m['exp']} (St={m['strouhal']})")
        ax.set_xlabel("t")
        ax.set_ylabel("vorticity at probe")
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(args.out, dpi=150)
        plt.close(fig)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
