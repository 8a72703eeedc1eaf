"""Simulation command line of the port: `python -m nmcfluid_torch.run <scene>
[options]` (port of nmcfluid/run.py).

The same flags, files and semantics as the JAX package's CLI, plus
`--device` (default the card; `--device cpu` runs on the CPU, and without
a card nothing else does). Per timestep it saves a checkpoint
(`<out>/<exp>/model/ckpt_step_tNNN.npz`, the JAX package's layout: a
checkpoint of either package resumes in the other) and optionally
velocity and vorticity frames, then optionally replays the density pass
(`--density`; for taylorgreen it writes the per-frame velocity error to
`error_ours.txt`). `--ckpt N` resumes from step N and `--until M` stops
at absolute step M.

Deliberate differences: `--fit_mode auto` is the fused fit on every
device (the JAX CLI picks its XLA loop on the CPU, where its kernel would
run interpreted); `--fit_unroll` is accepted and has no effect (the JAX
package's results are the same for any value); `--profile_dir` writes a
torch.profiler trace; the JAX CLI's compile cache has no counterpart;
`--mesh N` spreads the pressure solve's chunks over the first N CUDA
devices, whole chunks a device (N copies of --device when that is not a
CUDA device, which exercises the split on one device), where the JAX CLI
shards its point clouds over a jax Mesh.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .parallel import points_mesh
from .scenes import SCENES, get_scene
from .sim import sampling
from .sim.fluid import FitStats, NeuralFluid
from .utils.checkpoint import latest_step, load_ckpt, save_ckpt
from .utils.keys import Key


def build_parser():
    p = argparse.ArgumentParser(
        description="neural Monte Carlo fluid, PyTorch port")
    p.add_argument("scene", choices=sorted(SCENES))
    p.add_argument("--exp_name", default=None)
    p.add_argument("--out", default="results")
    p.add_argument("--n_timesteps", type=int, default=None)
    p.add_argument("--max_n_iters", type=int, default=None)
    p.add_argument("--sample_resolution", type=int, default=None)
    p.add_argument("--wost_resolution", type=int, default=None)
    p.add_argument("--div_resolution", type=int, default=None)
    p.add_argument("--n_walks", type=int, default=None)
    p.add_argument("--walk_step_cap", type=int, default=64,
                   help="step cap of the lockstep gradient and of the "
                        "solution-only walk (gen caps its walks at the "
                        "walk settings' gen_step_cap, pool mode at "
                        "--pool_step_cap)")
    p.add_argument("--walk_algo", default="gen",
                   choices=["pool", "gen", "lockstep"],
                   help="WoSt gradient executor: point-aligned "
                        "generations ('gen'), the compacted walker pool "
                        "('pool', cost ~ the sum of walk lengths) or the "
                        "lockstep pair loop ('lockstep': pairs walked side "
                        "by side, control variates refreshed per pair)")
    p.add_argument("--pool_step_cap", type=int, default=1024)
    p.add_argument("--adaptive_walks", type=float, default=0.0,
                   help="adaptive MC walk allocation on the pool: kappa "
                        "scaling of the equal-RMS-error optimal budget "
                        "n_i ~ sigma_i, in geometric rounds; 0 = the "
                        "reference's fixed n_walks per point (default; "
                        "a measured negative on karman in the JAX "
                        "package, PARITY.md:652)")
    p.add_argument("--grad_clip", type=float, default=-1.0,
                   help="global-l2 gradient clip for the phase fits, "
                        "<=0 off (config.py --grad_clip)")
    p.add_argument("--vis_frequency", type=int, default=0,
                   help="record the minibatch loss every N fit "
                        "iterations and write per-phase loss_*.txt "
                        "traces under txt/ (config.py:102; 0 = off; "
                        "runs the fresh-batch fit)")
    p.add_argument("--adv_ref", type=int, default=0)
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine", "tail"])
    p.add_argument("--fit_plateau", type=int, default=0,
                   help="stop a phase fit at the end of any N-iter "
                        "window that improved the smoothed loss by "
                        "<0.5%% relative (0 = reference behavior)")
    p.add_argument("--param_ema", type=float, default=0.0,
                   help="Polyak parameter averaging per phase (0 = off)")
    p.add_argument("--ls_head", type=int, default=8,
                   help="finish every phase fit with a closed-form "
                        "weighted-ridge solve of the final linear layer "
                        "over N fresh minibatches (0 = off)")
    p.add_argument("--fit_mode", default="auto",
                   choices=["auto", "xla", "fused"],
                   help="phase-fit executor: 'xla' = the fresh-batch Adam "
                        "loop (reference semantics: a fresh minibatch per "
                        "iteration), 'fused' = the whole fit in one CUDA "
                        "kernel cycling a --fit_pool-batch pool (its plain "
                        "PyTorch twin on the CPU; the fresh-batch loop "
                        "under param_ema/fit_plateau/grad_clip/"
                        "vis_frequency or a non-sine net); 'auto' "
                        "(default) = fused on every device (the JAX CLI "
                        "picks xla on the CPU)")
    p.add_argument("--fit_pool", type=int, default=512,
                   help="minibatch-pool size for --fit_mode fused")
    p.add_argument("--wost_source", default="grid",
                   choices=["grid", "net"],
                   help="walk source term: 'grid' is the reference's "
                        "nearest-texel lookup of the divergence grid; "
                        "'net' evaluates -div u of the network at the "
                        "sampled point (forward mode; no nearest-cell "
                        "error); read by --projection wost only")
    p.add_argument("--fit_ensemble", type=int, default=1,
                   help="average N independent phase fits from one "
                        "start on folded keys (default 1; a measured "
                        "negative in the JAX package, "
                        "error_bem_ens2_r5.txt)")
    p.add_argument("--fit_unroll", type=int, default=4,
                   help="accepted for the JAX CLI's sake; no effect (its "
                        "results are the same for any value)")
    p.add_argument("--projection", default="wost",
                   choices=["wost", "spectral", "bem", "bvc"],
                   help="the pressure solve: 'wost' the Monte Carlo walk "
                        "on stars; 'spectral' the DCT box solve (with the "
                        "circle, cylinder or sphere correction); 'bem' the "
                        "2D boundary-element solve; 'bvc' the 2D boundary "
                        "value caching (a walk at the boundary cache, the "
                        "BEM splat elsewhere)")
    # scene-hyperparameter overrides (config.py:87-156 argparse surface)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--bdry_eps", type=float, default=None)
    p.add_argument("--karman_vel", type=float, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--hidden_features", type=int, default=None)
    p.add_argument("--nonlinearity", default=None,
                   choices=["sine", "relu", "elu", "tanh"])
    p.add_argument("--sample", default=None, dest="sample_pattern",
                   choices=["random", "uniform", "random+uniform"])
    p.add_argument("--reset_wts", type=int, default=None)
    p.add_argument("--src_duration", type=int, default=None)
    p.add_argument("--vis_resolution", type=int, default=None)
    p.add_argument("--vel_vis_resolution", type=int, default=None)
    p.add_argument("--early_stop_loss", type=float, default=None)
    p.add_argument("--absorption", type=float, default=None,
                   help="screening coefficient sigma (wost.json "
                        "absorptionCoeff; 350 in every shipped config); "
                        "0 walks with the harmonic Green's functions")
    p.add_argument("--ckpt", type=int, default=-1,
                   help="resume from step N (config.py --ckpt). Like the "
                        "reference's loop, --n_timesteps counts steps run "
                        "THIS invocation, not the absolute final step")
    p.add_argument("--until", type=int, default=None,
                   help="stop once the absolute step counter reaches N")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--draw", action="store_true",
                   help="save velocity/vorticity pngs per frame (needs "
                        "matplotlib)")
    p.add_argument("--density", action="store_true",
                   help="run the density/export replay after simulating")
    p.add_argument("--density_only", action="store_true",
                   help="skip simulation: run only the density/export "
                        "replay over the checkpoints already in the "
                        "experiment dir")
    p.add_argument("--density_resolution", type=int, default=None,
                   help="density transport grid (default: the "
                        "reference's 1000^2 / 200^3, move_density.py)")
    p.add_argument("--mesh", type=int, default=0,
                   help="walk the pressure chunks on N devices, whole "
                        "chunks a device (0 = off): the first N CUDA "
                        "devices, or N copies of --device when it is not "
                        "a CUDA device")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of this run's first "
                        "timestep to DIR/trace.json")
    p.add_argument("--stage_times", action="store_true",
                   help="print the per-stage wall-clock breakdown "
                        "(advect fit / div grid / WoSt / projection fit) "
                        "each timestep")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card, and an error "
                        "without one); 'cpu' runs on the CPU")
    return p


def parse_args(argv=None):
    """Parse argv; --draw without matplotlib is a usage error, raised here
    before anything runs."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.draw:
        from .utils.vis import have_matplotlib
        if not have_matplotlib():
            p.error("--draw needs matplotlib, which is not installed")
    return args


def scene_with_overrides(args):
    scene = get_scene(args.scene)
    over = {}
    for f in ("lr", "dt", "bdry_eps", "karman_vel", "num_hidden_layers",
              "hidden_features", "nonlinearity", "sample_pattern",
              "src_duration", "vis_resolution", "vel_vis_resolution",
              "early_stop_loss", "absorption"):
        v = getattr(args, f)
        if v is not None:
            over[f] = v
    if args.reset_wts is not None:
        over["reset_wts"] = bool(args.reset_wts)
    return dataclasses.replace(scene, **over) if over else scene


def make_fluid(args):
    """The NeuralFluid of the flags. --fit_unroll changes no result."""
    scene = scene_with_overrides(args)
    mesh = None
    if args.mesh:
        if torch.device(args.device).type == "cuda":
            mesh = points_mesh(args.mesh)
        else:
            mesh = points_mesh(devices=[args.device] * args.mesh)
    ws = None
    if (args.n_walks or args.walk_step_cap != 64 or args.walk_algo != "gen"
            or args.pool_step_cap != 1024 or args.adaptive_walks > 0.0):
        ws = scene.walk_settings(n_walks=args.n_walks or scene.n_walks,
                                 walk_step_cap=args.walk_step_cap,
                                 algo=args.walk_algo,
                                 pool_step_cap=args.pool_step_cap,
                                 adaptive_walks=args.adaptive_walks)
    return NeuralFluid(scene,
                       max_n_iters=args.max_n_iters,
                       sample_resolution=args.sample_resolution,
                       wost_resolution=args.wost_resolution,
                       div_resolution=args.div_resolution,
                       walk_settings=ws,
                       adv_ref=bool(args.adv_ref),
                       projection=args.projection,
                       lr_schedule=args.lr_schedule,
                       param_ema=args.param_ema,
                       grad_clip=args.grad_clip,
                       fit_plateau=args.fit_plateau,
                       ls_head=args.ls_head,
                       fit_mode=args.fit_mode,
                       fit_pool=args.fit_pool,
                       fit_ensemble=args.fit_ensemble,
                       wost_source=args.wost_source,
                       loss_trace=args.vis_frequency,
                       mesh=mesh,
                       device=args.device)


def _np(t):
    return t.detach().cpu().numpy()


def draw_frame(fluid, state, dirs, t):
    from .ops.diff_ops import curl2d
    from .utils import vis
    scene = fluid.scene
    res = scene.vel_vis_resolution
    u = _np(fluid.sample_velocity_grid(state, res))
    pts = _np(sampling.uniform_grid(scene.scene_size, res, True))
    vis.save_txt_grid(os.path.join(dirs["txt"],
                                   f"velocity_values_t{t:03d}.txt"), u)
    vis.save_txt_grid(os.path.join(dirs["txt"],
                                   f"velocity_samples_t{t:03d}.txt"), pts)
    if scene.dim == 2:
        vis.draw_vector_field2d(u[..., 0], u[..., 1], pts[..., 0],
                                pts[..., 1],
                                os.path.join(dirs["velocity"],
                                             f"velocity_t{t:03d}.png"))
        grid = sampling.uniform_grid(scene.scene_size, scene.vis_resolution,
                                     device=fluid.device)
        w = _np(curl2d(
            lambda p: fluid.velocity(state.params, p, eps=state.eps,
                                     t=state.timestep),
            grid))
        vis.draw_scalar_field2d(w, os.path.join(dirs["vorticity"],
                                                f"vorticity_t{t:03d}.png"),
                                vmin=-5, vmax=5)
        np.savetxt(os.path.join(dirs["txt"], f"vorticity_values_t{t:03d}.txt"),
                   w.reshape(-1, 1))


def dump_pressure_debug(fluid, dirs, t):
    """Per-projection debug artifacts (model_split.py:249-270): scatter
    plots of p and grad p over the pressure cloud + the divergence grid."""
    from .utils import vis
    proj = getattr(fluid, "_last_projection", None)
    if proj is None or fluid.scene.dim != 2:
        return
    pts, p, grad_p, div = (_np(a) for a in proj)
    pdir = dirs["pressure"]
    vis.draw_scatter(pts, p, os.path.join(pdir, f"p_t{t:03d}.png"))
    vis.draw_scatter(pts, grad_p[:, 0],
                     os.path.join(pdir, f"gradp_x_t{t:03d}.png"))
    vis.draw_scatter(pts, grad_p[:, 1],
                     os.path.join(pdir, f"gradp_y_t{t:03d}.png"))
    vis.draw_scalar_field2d(div, os.path.join(pdir, f"div_t{t:03d}.png"))


def load_energy(exp_dir, ckpt):
    """Preload the kinetic-energy curve on --ckpt resume so the per-step
    overwrite of energy.txt (3d/main.py:168-179 semantics) keeps the
    pre-resume rows. Row k holds the energy after step k+1, so a resume
    from checkpoint N keeps at most the first N rows."""
    path = os.path.join(exp_dir, "energy.txt")
    if ckpt <= 0 or not os.path.exists(path):
        return []
    rows = np.loadtxt(path, ndmin=1)
    return [float(e) for e in rows[:ckpt]]


def assemble_gifs(exp_dir, dirs):
    """Per-run gif assembly (2d/vis_utils.py:103-106)."""
    from .utils import vis
    for sub, pattern in (("velocity", "velocity_t"),
                         ("vorticity", "vorticity_t"),
                         ("density", "density_t")):
        d = dirs.get(sub, os.path.join(exp_dir, sub))
        if os.path.isdir(d):
            try:
                vis.frames_to_gif(d, pattern,
                                  os.path.join(exp_dir, f"{sub}.gif"))
            except (ValueError, OSError):
                pass  # no frames written for this artifact


def run_density(fluid, args, exp_dir, model_dir):
    """The density replay over every checkpoint (move_density.py): a png
    a frame in 2D (an npz of the density where matplotlib is missing, as
    on a card's machine that has none), a VDB (with pyopenvdb) or else an
    npz a frame in 3D, and for taylorgreen the velocity error a frame in
    error_ours.txt."""
    from .transport.density import init_density, transport_rollout
    from .utils import vis
    scene = fluid.scene
    dens_dir = os.path.join(exp_dir, "density")
    os.makedirs(dens_dir, exist_ok=True)
    last = latest_step(model_dir)
    params0 = fluid.init_state(key=Key.from_seed(args.seed)).params

    def params_iter():
        for t in range(last + 1):
            try:
                params, _ = load_ckpt(model_dir, params0, t)
            except FileNotFoundError:
                return
            yield params

    errors = []
    pngs = vis.have_matplotlib()
    if scene.dim == 2 and not pngs:
        print("matplotlib is not installed: density frames go to npz")
    vdb = None
    try:
        import pyopenvdb as vdb  # optional (README Setup)
    except ImportError:
        pass
    # vortex_collide ships a red/blue ring color grid in every frame's VDB
    # (3d/move_density.py:112-116,230-243)
    n_dens = args.density_resolution or (1000 if scene.dim == 2 else 200)
    col = None
    if scene.name == "vortex_collide":
        col = _np(init_density(scene, n_dens, device=fluid.device)[1])
    # each frame's wall-clock: the transport (the raw velocity grid, the
    # pull, the TG error; frame 0 also the initial density), then the write
    t0 = time.perf_counter()
    for t, d_grid, vel, err in transport_rollout(
            fluid, params_iter(), n=n_dens, key=Key.from_seed(0)):
        _sync(fluid)
        t1 = time.perf_counter()
        if scene.dim == 2 and not pngs:
            np.savez_compressed(os.path.join(dens_dir,
                                             f"density_t{t:03d}.npz"),
                                density=_np(d_grid))
        elif scene.dim == 2:
            vis.draw_scalar_field2d(_np(d_grid),
                                    os.path.join(dens_dir,
                                                 f"density_t{t:03d}.png"),
                                    cmap="Blues")
        elif vdb is not None:
            den = vdb.FloatGrid()
            den.copyFromArray(_np(d_grid))
            den.transform = vdb.createLinearTransform(voxelSize=0.01)
            den.name = "density"
            velg = vdb.Vec3SGrid()
            velg.copyFromArray(_np(vel))
            velg.transform = vdb.createLinearTransform(voxelSize=0.01)
            velg.name = "vel"
            grids = [den, velg]
            if col is not None:
                cg = vdb.Vec3SGrid()
                cg.copyFromArray(col)
                cg.transform = vdb.createLinearTransform(voxelSize=0.01)
                cg.name = "Cd"
                grids.append(cg)
            vdb.write(os.path.join(dens_dir, f"density_t{t:03d}.vdb"),
                      grids=grids)
        else:
            extra = {"Cd": col} if col is not None else {}
            np.savez_compressed(os.path.join(dens_dir,
                                             f"density_t{t:03d}.npz"),
                                density=_np(d_grid), vel=_np(vel), **extra)
        tg = ""
        if err is not None:
            errors.append(err)
            tg = f" tg_err={err:.6e}"
        t2 = time.perf_counter()
        print(f"density t={t}{tg} (transport {t1 - t0:.3f} s, write "
              f"{t2 - t1:.3f} s)", flush=True)
        t0 = t2
    if errors:
        np.savetxt(os.path.join(exp_dir, "error_ours.txt"), errors)
        print("Mean Error:", float(np.mean(errors)))


def _code_revision():
    """Git commit of the running code (+ dirty marker), or None outside a
    checkout — stamped into config.json so every experiment records the
    exact revision that produced it."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        rev = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
        if rev.returncode != 0:
            return None
        dirty = subprocess.run(
            ["git", "-C", root, "status", "--porcelain",
             "--untracked-files=no"],
            capture_output=True, text=True, timeout=10)
        mark = "-dirty" if dirty.stdout.strip() else ""
        return rev.stdout.strip() + mark
    except (OSError, subprocess.TimeoutExpired):
        return None


def _sync(fluid):
    if fluid.device.type == "cuda":
        torch.cuda.synchronize(fluid.device)


def _profiler(fluid):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if fluid.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _executors(stats):
    """Which executor ran each fit of the last add_source or step."""
    stats = (stats,) if isinstance(stats, FitStats) else stats
    return "/".join(s.executor for s in stats)


def main(argv=None):
    args = parse_args(argv)
    # every unported scene or flag raises here, before any file is written
    fluid = make_fluid(args)
    scene = fluid.scene
    exp = args.exp_name or args.scene
    exp_dir = os.path.join(args.out, exp)
    model_dir = os.path.join(exp_dir, "model")
    dirs = {k: os.path.join(exp_dir, k)
            for k in ("velocity", "vorticity", "txt", "pressure")}
    for d in [exp_dir, model_dir] + list(dirs.values()):
        os.makedirs(d, exist_ok=True)
    # the exact code revision alongside the flags (config.py:49-56
    # snapshots the source tree instead)
    cfg = dict(vars(args))
    cfg["code_revision"] = _code_revision()
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)

    if args.density_only:
        run_density(fluid, args, exp_dir, model_dir)
        dirs["density"] = os.path.join(exp_dir, "density")
        assemble_gifs(exp_dir, dirs)
        return
    n_steps = args.n_timesteps or scene.n_timesteps

    state = fluid.init_state(key=Key.from_seed(args.seed))
    if args.ckpt > 0:
        # a resume restarts the key tree from the seed, as the JAX CLI does
        params, t = load_ckpt(model_dir, state.params, args.ckpt)
        state = state._replace(params=params, timestep=t)
        print(f"resumed from step {t}")
    else:
        t0 = time.time()
        state = fluid.add_source(state)
        _sync(fluid)
        stats = fluid._last_stats
        print(f"add_source: {int(stats.iters)} iters, "
              f"loss {float(stats.loss):.3e}, {time.time() - t0:.1f}s "
              f"fit={_executors(stats)}", flush=True)
        save_ckpt(model_dir, state.params, 0)
        if args.draw:
            draw_frame(fluid, state, dirs, 0)

    # the karman family halves the ramp width after fitting the IC
    # (main.py:161-163)
    state = state._replace(eps=scene.eps_after_source(state.eps))

    fluid.profile = bool(args.stage_times)
    energy = load_energy(exp_dir, args.ckpt)
    if args.until is not None:
        n_steps = max(0, args.until - int(state.timestep))
    for it in range(n_steps):
        t0 = time.time()
        # re-fit the source while the ABSOLUTE frame counter is in
        # (0, src_duration) (main.py:164-171), at the upcoming step's time
        ts = int(state.timestep)
        if 0 < ts < scene.src_duration:
            state = fluid.add_source(state._replace(timestep=ts + 1))
            state = state._replace(timestep=state.timestep - 1)
        tracing = args.profile_dir and it == 0
        with (_profiler(fluid) if tracing
              else contextlib.nullcontext()) as prof:
            fluid.stage_times = {}
            state = fluid.step(state)
            _sync(fluid)
        if tracing:
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            print(f"profiler trace -> {path}")
        t = int(state.timestep)
        stats = fluid._last_stats
        iters = ""
        if args.fit_plateau > 0:
            iters = " iters=" + "/".join(str(int(s.iters)) for s in stats)
        print(f"timestep {t}: {time.time() - t0:.1f}s "
              f"P={float(state.P):.3e}{iters} fit={_executors(stats)}",
              flush=True)
        if args.stage_times and fluid.stage_times:
            print("  stages: " + "  ".join(
                f"{k}={v:.1f}s" for k, v in fluid.stage_times.items()))
        save_ckpt(model_dir, state.params, t)
        if args.vis_frequency:
            for name, st in zip(("advect", "project", "advect2",
                                 "project2"), stats):
                if st.trace is not None:
                    np.savetxt(os.path.join(
                        dirs["txt"], f"loss_{name}_t{t:03d}.txt"),
                        _np(st.trace))
        if args.draw:
            draw_frame(fluid, state, dirs, t)
            dump_pressure_debug(fluid, dirs, t)
        if scene.dim == 3:
            # kinetic-energy curve (3d/main.py:168-179)
            energy.append(float(fluid.kinetic_energy(state)))
            np.savetxt(os.path.join(exp_dir, "energy.txt"), energy)

    if args.density:
        run_density(fluid, args, exp_dir, model_dir)
    if args.draw or args.density:
        dirs["density"] = os.path.join(exp_dir, "density")
        assemble_gifs(exp_dir, dirs)


if __name__ == "__main__":
    main()
