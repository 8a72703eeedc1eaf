"""Benchmark entry of the port: seconds per frame of one scene at its
shipped width, on the card (the counterpart of the JAX package's
bench.py).

    python -m nmcfluid_torch.bench                  # Taylor-Green, card
    NMCFLUID_BENCH_SCENE=smoke python -m nmcfluid_torch.bench
    python -m nmcfluid_torch.bench --device cpu     # the CPU, if asked

Prints ONE JSON line: {"metric": "<scene><dim>d_sec_per_frame", "value",
"unit": "s", "vs_baseline", "device"}. The frame is what bench.py times:
NeuralFluid(scene) at the catalog's widths, add_source (the karman
family's ramp width then halved, as the JAX CLI does), one warm step, one
timed step ending in a device synchronize, then a third step with
per-stage timing on (`profile`) for the breakdown. vs_baseline is
BASELINE_WALL.json's `<scene>_sec_per_frame` (the reference's C++ WoSt
stage on one CPU core) over the timed step, > 1 meaning faster; 1.0 where
the file has no entry for the scene.

The detail JSON goes to NMCFLUID_BENCH_DETAIL, by default
chiprun_out/bench_<scene>.json under the repository (git-ignored): the
warm and timed steps, the stage breakdown, the fit kernel's device time
and its share of the f32 bound (`fit_mfu`), the walk's generations, steps
and lanes (`wost/gen.py::counts`), peak device memory, and the card's name
and power limit as nvidia-smi gives them.

Overrides for quick checks, as bench.py's: NMCFLUID_BENCH_SCENE,
NMCFLUID_BENCH_SCALE (divides the resolutions, the walks and the fit
pool), NMCFLUID_BENCH_ITERS (caps the Adam iterations of every fit).

The flagship frame, as bench.py's: the same frame under the scene's
deterministic projection (bem in 2D, spectral in 3D) from its own
add_source, one warm step, one timed step and one profiled step, written
to the detail file under "flagship" with its stage breakdown (the BEM's
one-time host precompute falls in the warm step);
NMCFLUID_BENCH_FLAGSHIP=0 skips it. The printed line is the walk's frame
alone.

Left out: bench.py's backend probe, a TPU workaround. Without a card and without `--device cpu` the entry prints
the error line and exits nonzero, as it does on any error.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fluid(scene, scale, iters, device, projection="wost"):
    from .sim.fluid import NeuralFluid
    div = None if scale == 1 else max(
        32, (1000 if scene.dim == 2 else scene.vis_resolution) // scale)
    return NeuralFluid(
        scene, device=device, projection=projection,
        max_n_iters=iters or scene.max_n_iters,
        sample_resolution=max(8, scene.sample_resolution // scale),
        wost_resolution=max(8, scene.wost_resolution // scale),
        div_resolution=div, n_walks=max(8, scene.n_walks // scale),
        fit_pool=max(4, 512 // scale))


def detail_path(scene_name):
    """NMCFLUID_BENCH_DETAIL, else chiprun_out/bench_<scene>.json under the
    repository (git-ignored)."""
    return os.environ.get("NMCFLUID_BENCH_DETAIL") or os.path.join(
        _ROOT, "chiprun_out", f"bench_{scene_name}.json")


def _fit_mfu(fluid, stages):
    """The fit kernel's device time in the profiled step (both phase
    fits) and its share of the f32 bound of as many iterations."""
    from .sim.fitkernel import iteration_work
    from .utils import h100
    t = stages.get("fit_kernel")
    if t is None:
        return None                  # the CPU runs the plain twin
    iters = 2 * fluid.max_n_iters
    bound, by = h100.bound_ms(*iteration_work(fluid.siren_cfg,
                                              fluid.n_batch))
    ms = t * 1e3 / iters
    return {"fit_kernel_s": t, "iters": iters, "ms_per_iter": ms,
            "bound_ms_per_iter": bound, "bound_by": by,
            "share_of_f32_bound": bound / ms}


def _frame(fluid, scene, device):
    """add_source (the ramp width then halved where the scene says), a
    warm step, a timed step ending in a synchronize, and a step with the
    stage breakdown on (synchronized between stages); returns (warm s,
    timed s, stages, the walk's counts in that step). The steps' output
    must be finite."""
    from .wost import gen
    state = fluid.add_source(fluid.init_state(0))
    state = state._replace(eps=scene.eps_after_source(state.eps))
    t0 = time.perf_counter()
    state = fluid.step(state)                         # warm
    _sync(device)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = fluid.step(state)
    _sync(device)
    sec = time.perf_counter() - t0
    fluid.profile, fluid.stage_times = True, {}
    gen.counts.update(dict.fromkeys(gen.counts, 0))
    state = fluid.step(state)
    _sync(device)
    for t in [state.P] + [a for pair in state.params for a in pair]:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError("the frame's output is not finite")
    return warm, sec, dict(fluid.stage_times), dict(gen.counts)


def run(scene_name, scale, iters, device):
    """Time the frame; returns (json line, detail)."""
    from . import get_device
    from .scenes import get_scene

    device = get_device(device)
    scene = get_scene(scene_name)
    fluid = _fluid(scene, scale, iters, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warm, sec, stages, walk = _frame(fluid, scene, device)
    flagship = None
    if os.environ.get("NMCFLUID_BENCH_FLAGSHIP") != "0":
        proj = "bem" if scene.dim == 2 else "spectral"
        fl2 = _fluid(scene, scale, iters, device, projection=proj)
        fwarm, fsec, fstages, _ = _frame(fl2, scene, device)
        flagship = {"projection": proj, "warm_step_s": fwarm,
                    "timed_step_s": fsec, "stage_breakdown_s": fstages,
                    "fit_mfu": _fit_mfu(fl2, fstages)}

    baseline = None
    try:
        with open(os.path.join(_ROOT, "BASELINE_WALL.json")) as f:
            baseline = json.load(f).get(f"{scene_name}_sec_per_frame")
    except (OSError, json.JSONDecodeError):
        pass
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    line = {"metric": f"{scene_name}{scene.dim}d_sec_per_frame",
            "value": sec, "unit": "s",
            "vs_baseline": baseline / sec if baseline else 1.0,
            "device": name}
    detail = {
        "scene": scene_name, "scale": scale, "iters": fluid.max_n_iters,
        "warm_step_s": warm, "timed_step_s": sec,
        "stage_breakdown_s": stages, "fit_mfu": _fit_mfu(fluid, stages),
        "walk": walk, "flagship": flagship,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
        "device": name, "card": _card_line() if on_card else None,
        "baseline_s": baseline,
        "baseline_host": "1-core CPU (reference wost stage)"}
    return line, detail


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device; default: the card (raises without "
                        "one); 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    scene_name = os.environ.get("NMCFLUID_BENCH_SCENE", "taylorgreen")
    metric = f"{scene_name}_sec_per_frame"
    try:
        from .scenes import get_scene
        metric = f"{scene_name}{get_scene(scene_name).dim}d_sec_per_frame"
        iters = os.environ.get("NMCFLUID_BENCH_ITERS")
        line, detail = run(
            scene_name, int(os.environ.get("NMCFLUID_BENCH_SCALE", "1")),
            int(iters) if iters else None, args.device)
        path = detail_path(scene_name)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(detail, f, indent=2)
    except Exception as e:    # noqa: BLE001 — the contract: one JSON line
        print(json.dumps({"metric": metric, "value": None, "unit": "s",
                          "vs_baseline": None,
                          "error": f"{type(e).__name__}: {e}"[:400]}))
        raise SystemExit(1)
    print(json.dumps(line))
    return line, detail


if __name__ == "__main__":
    main(sys.argv[1:])
