"""The benchmark of nmcfluid_torch, the PyTorch and CUDA neural Monte Carlo
fluid, on one NVIDIA H100.

    python3 -m nmcbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (configs/<name>.json, its
plain reference configs/<name>.py) and a traffic mix (traffic/<name>.json).
A run builds the configuration's NeuralFluid with every setting its file
states, makes the start weights on the card from the seed, warms the
cell's shapes with one cut frame (the traffic file's `warmup`: the whole
pool of fit batches, 32 Adam iterations), then
advances the fluid frame after frame, a closed loop, for --seconds: the
window runs whole frames and ends with the first frame that ends at or
after --seconds, so its time per frame is the window's time over all its
frames. With --trace 1 the same window runs with the program's stage
timing on, and one more frame (the traffic file's `traced_frame`) runs
under torch.profiler. Once the window has closed, one frame drawn from the
seed before the window, among as many of its first frames as the cell's
limits file says every window holds, is held against the plain reference
(reference/check.py) with the cell's limits (limits/<cell>.json).

Each end-to-end and per-layer metric is read by its own file,
metrics/<name>.py, found by the name BENCHMARK.json gives it. The last
line of standard output is the result, one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key. Build and kernel caches stay inside the checkout.
"""
import argparse
import dataclasses
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "nmcbench")
CACHE = os.path.join(ROOT, ".nmcbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "nmcfluid")


class Refused(Exception):
    """A run that cannot produce a result: the message goes to stderr and
    the process exits nonzero without printing one."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Top-level names in sys.modules that the run may not hold, compared
    whole (nmcfluid_torch is not nmcfluid)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic, limits
    and metrics, each found by name."""

    def __init__(self, name, bench=None, here=HERE):
        self.bench = bench or load_json(ROOT, "BENCHMARK.json")
        self.here = here
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        self.cfg = load_json(here, "configs", self.spec["config"] + ".json")
        self.traffic = load_json(here, "traffic",
                                 self.spec["traffic"] + ".json")
        self.limits = load_json(here, "limits", name + ".json")
        self.scene_ref = load_module(
            os.path.join(here, "configs", self.spec["config"] + ".py"),
            "nmcbench_ref_" + self.spec["config"])

    def metrics(self, kind):
        """[(entry, reader module)] of the cell's end_to_end or per_layer
        metrics: those without a `workloads` key and those that list it."""
        out = []
        for m in self.bench[kind]:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            out.append((m, load_module(
                os.path.join(self.here, "metrics", m["name"] + ".py"),
                "nmcbench_metric_" + m["name"].replace(".", "_"))))
        return out


# ------------------------------------------------------------- program

def make_fluid(cell, device):
    """The configuration's NeuralFluid, every setting passed explicitly."""
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.sim.fluid import NeuralFluid
    from nmcfluid_torch.wost.solver import WalkSettings
    cfg, tr = cell.cfg, cell.traffic
    sf = cfg["scene_fields"]
    scene = dataclasses.replace(get_scene(cfg["scene"]),
                                **{k: _tuples(v) for k, v in sf.items()})
    walk = dict(cfg["walk"], **tr.get("walk", {}))
    # each setting is in the file once: the scene's, also where the fluid
    # and the walk take it
    return NeuralFluid(scene, walk_settings=WalkSettings(
        n_walks=sf["n_walks"], **walk), projection=tr["projection"],
        wost_source=tr["wost_source"], device=device,
        max_n_iters=sf["max_n_iters"],
        sample_resolution=sf["sample_resolution"],
        wost_resolution=sf["wost_resolution"], n_walks=sf["n_walks"],
        **cfg["fluid"])


def _tuples(v):
    return tuple(_tuples(a) for a in v) if isinstance(v, list) else v


def start_state(cell, seed, device):
    """The seeded start: SIREN weights made on the device by the
    benchmark's own initialisation, the program's key from the seed."""
    import torch
    from nmcfluid_torch.sim.fluid import SimState
    from nmcfluid_torch.utils.keys import Key
    from nmcbench.reference import siren
    s = cell.cfg["scene_fields"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    params = siren.init(gen, s["dim"], s["dim"], s["hidden_features"],
                        s["num_hidden_layers"], device)
    return SimState(params=params, P=torch.zeros((), device=device),
                    eps=float(s["bdry_eps"]), timestep=0, key=Key(seed))


@dataclasses.dataclass
class Cut:
    """Settings of a cut frame: fewer Adam iterations and pool batches,
    fewer walks and walk chunks; 0 keeps the cell's own. The shapes stay
    the cell's."""
    max_n_iters: int
    fit_pool: int
    n_walks: int
    walk_chunks: int


def run_cut(fluid, state, cut):
    """One frame with `cut` applied, then the fluid's settings restored."""
    saved = (fluid.max_n_iters, fluid.fit_pool, fluid.n_pressure,
             fluid.walk_settings)
    if cut.max_n_iters:
        fluid.max_n_iters = cut.max_n_iters
    if cut.fit_pool:
        fluid.fit_pool = cut.fit_pool
    if fluid.projection == "wost":
        if cut.walk_chunks:
            fluid.n_pressure = fluid.wost_chunk * cut.walk_chunks
        if cut.n_walks:
            fluid.walk_settings = dataclasses.replace(
                fluid.walk_settings, n_walks=cut.n_walks)
    try:
        return fluid.step(state)
    finally:
        (fluid.max_n_iters, fluid.fit_pool, fluid.n_pressure,
         fluid.walk_settings) = saved


class Recorder:
    """Keeps what one frame of the window took in and gave out, for the
    check: frame `index` (1-based), drawn from the seed before the window
    starts, so that no other frame's record is ever kept. It wraps the
    program's fused fit, head solve and the traffic's pressure solve,
    whose results it passes on unchanged: the phase fits' pools and
    weights, and the cloud's `valid` flags; the rest of the projection is
    the fluid's last. Its tensors stay on the device until the check, so
    `held` gives their bytes, which the memory peak leaves out."""

    def __init__(self, index):
        self.index = index
        self.cur = self.kept = None
        self.held = 0

    def install(self, fluid_mod, projection):
        from nmcbench.reference.check import Record
        self.Record = Record
        solve_name = "_pressure_solve_" + projection
        fused, head, solve = (getattr(fluid_mod, n) for n in (
            "fused_adam_fit", "_ls_head_solve", solve_name))
        self._saved = (fluid_mod, fused, head, solve_name, solve)
        rec = self

        def fused_adam_fit(params, cfg, pool, n_iters, lr):
            out = fused(params, cfg, pool, n_iters, lr)
            if rec.cur is not None:
                rec.cur.phases[rec.phase].update(
                    params0=params, pool=pool, n_iters=n_iters, lr=lr,
                    adam=out[0])
            return out

        def ls_head_solve(fluid, params, key, batch_fn):
            if rec.cur is None:
                return head(fluid, params, key, batch_fn)
            sink = []
            out = head(fluid, params, key, _Batches(batch_fn, sink))
            ph = rec.cur.phases[rec.phase]
            ph.update(head=sink, out=out)
            rec.phase = "prj"
            return out

        def pressure_solve(*args):
            out = solve(*args)
            if rec.cur is not None:
                rec.cur.valid = out[1]
            return out

        fluid_mod.fused_adam_fit = fused_adam_fit
        fluid_mod._ls_head_solve = ls_head_solve
        setattr(fluid_mod, solve_name, pressure_solve)

    def uninstall(self):
        fluid_mod, fused, head, solve_name, solve = self._saved
        fluid_mod.fused_adam_fit, fluid_mod._ls_head_solve = fused, head
        setattr(fluid_mod, solve_name, solve)

    def begin(self, state):
        self.cur = self.Record()
        self.cur.prev = state.params
        self.cur.eps = state.eps
        self.cur.t = state.timestep + 1
        self.phase = "adv"

    def end(self, fluid):
        cur = self.cur
        cur.pts, cur.p, cur.grad_p, cur.div = fluid._last_projection
        cur.projection = fluid.projection
        cur.phases["prj"]["prev"] = cur.phases["adv"]["out"]
        self.kept, self.cur = cur, None
        self.held = device_bytes(vars(cur))


def device_bytes(obj):
    """Bytes of the CUDA storages that obj's tensors (in dicts, lists and
    tuples) hold, each storage once, in the allocator's 512-byte
    blocks."""
    import torch
    seen = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                st = o.untyped_storage()
                seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
    walk(obj)
    return sum(seen.values())


class _Batches:
    """A phase's batch function that records the batches drawn through it
    (the head solve's) and is otherwise the program's."""

    def __init__(self, inner, sink):
        self._inner, self._sink = inner, sink

    def batch(self, kb):
        out = self._inner.batch(kb)
        self._sink.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ------------------------------------------------------------------ run

class Context:
    """What the metric readers read."""

    def __init__(self, cell):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.frames = 0
        self.window_s = self.setup_s = None
        self.stage_s = {}           # per frame, from the program's stages
        self.counts = {}            # per frame, the program's counters
        self.busy_s = self.traced_s = None


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class Peak:
    """The device's memory peak of the frames the recorder does not
    record: the process's peak before the recorded frame, and after it
    less the record's bytes. Where the recorded frame is the only one,
    its own peak, record included."""

    def __init__(self, device, torch):
        self.cuda = device.type == "cuda"
        self.torch, self.device = torch, device
        self.before = self.during = self.after = None

    def _max(self):
        return self.torch.cuda.max_memory_allocated(self.device) \
            if self.cuda else 0

    def begin_recorded(self, frame):
        self.before = self._max() if frame > 1 else None

    def end_recorded(self):
        self.during = self._max()
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def read(self, recorder, frames_after):
        if frames_after:
            self.after = self._max() - recorder.held
        found = [v for v in (self.before, self.after) if v is not None]
        return max(found) if found else self.during


def window(fluid, state, seconds, recorder, peak, torch):
    """Whole frames until one ends at or after `seconds`: (state, frames,
    seconds, each frame's end in seconds, the frames run past the
    window's end, the frames run after the recorded one). Frame
    recorder.index is recorded; where the window ends before it, frames
    run on past the window's end, untimed, until it has been."""
    frames, ends = 0, []
    t0 = time.perf_counter()
    while True:
        frames += 1
        state = _frame(fluid, state, frames, recorder, peak, torch)
        t = time.perf_counter() - t0
        ends.append(t)
        if t >= seconds:
            break
    n = frames
    while recorder.kept is None:
        n += 1
        state = _frame(fluid, state, n, recorder, peak, torch)
    return state, frames, ends[-1], ends, n - frames, n - recorder.index


def _frame(fluid, state, number, recorder, peak, torch):
    if number == recorder.index:
        peak.begin_recorded(number)
        recorder.begin(state)
    state = fluid.step(state)
    if fluid.device.type == "cuda":
        torch.cuda.synchronize(fluid.device)
    if number == recorder.index:
        recorder.end(fluid)
        peak.end_recorded()
    return state


def traced_frame(fluid, state, cut, torch):
    """One frame (cut as the traffic file's traced_frame says) under
    torch.profiler, each program stage a named host range: (busy s,
    wall s, device_ops, idle_gaps)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from nmcbench.yardstick import devtrace
    timed = fluid._timed

    def named(name, fn, *args):
        with record_function("stage:" + name):
            return timed(name, fn, *args)

    def sync():
        if fluid.device.type == "cuda":
            torch.cuda.synchronize(fluid.device)

    fluid._timed = named
    try:
        acts = [ProfilerActivity.CPU]
        if fluid.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_cut(fluid, state, cut)
            sync()
            wall = time.perf_counter() - t0
    finally:
        del fluid._timed
    kernels, ranges = devtrace.raw_events(prof)
    busy, ops, gaps = devtrace.reduce_events(kernels, ranges)
    return busy, wall, ops, gaps


def run_cell(cell, seed, seconds, trace, device, t_start, keep=None,
             check_frames=None):
    """Set up, run the window, check: (result, notes), the result without
    the forbidden-module look, which main makes last. With `keep` (a
    dict), the checked frame's record is left under keep["record"];
    `check_frames` replaces the limits file's."""
    import torch
    from nmcfluid_torch.sim import fitkernel
    from nmcfluid_torch.sim import fluid as fluid_mod
    from nmcbench.reference.check import check_frame, judge
    from nmcbench.reference.frame import Scene
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ctx = Context(cell)
    # set-up, part by part: imports (from the process's start), the CUDA
    # context, the fit kernel's library, the fluid with its start state,
    # the warm-up frame
    t = time.perf_counter()
    notes = {"seed": seed, "cell": cell.name, "imports_s": t - t_start}
    if on_card:
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    notes["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if on_card:
        fitkernel.load_library()        # builds on a checkout's first run
    notes["build_or_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fluid = make_fluid(cell, dev)
    state = start_state(cell, seed, dev)
    notes["fluid_s"] = time.perf_counter() - t
    t = time.perf_counter()
    run_cut(fluid, state, Cut(**cell.traffic["warmup"]))
    if on_card:
        torch.cuda.synchronize()
    notes["warmup_s"] = time.perf_counter() - t
    index = check_frame_index(seed, check_frames
                              or cell.limits["check_frames"])
    recorder = Recorder(index)
    recorder.install(fluid_mod, fluid.projection)
    peak = Peak(dev, torch)
    fluid.profile = bool(trace)
    fluid.stage_times = {}
    counts = program_counters(cell.traffic)
    for k in counts:
        counts[k] = 0
    ctx.setup_s = time.perf_counter() - t_start
    state, frames, wall, ends, past, after = window(
        fluid, state, seconds, recorder, peak, torch)
    run = frames + past
    notes.update(frame_ends_s=ends, frames_past_window=past)
    ctx.frames, ctx.window_s = frames, wall
    ctx.stage_s = {k: v / run for k, v in fluid.stage_times.items()}
    ctx.counts = {k: v / run for k, v in counts.items()}
    result = {"correct": False, "attempted": frames, "failed": 0}
    breakdown = None
    if trace:
        fluid.profile = False
        busy, twall, ops, gaps = traced_frame(
            fluid, state, Cut(**cell.traffic["traced_frame"]), torch)
        ctx.busy_s, ctx.traced_s = busy, twall
        breakdown = {"device_ops": ops, "idle_gaps": gaps}
    recorder.uninstall()
    mem = peak.read(recorder, after + bool(trace))
    metrics = {}
    for m, reader in cell.metrics("per_layer" if trace else "end_to_end"):
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    notes.update(frames=frames, window_s=wall, stage_s=ctx.stage_s,
                 walk_counts=ctx.counts, memory_peak_bytes=mem,
                 record_bytes=recorder.held, checked_frame=index)
    del state, fluid
    rec = recorder.kept
    recorder.kept = None
    if keep is not None:
        keep["record"] = rec
    t = time.perf_counter()
    scene = Scene(cell.cfg, cell.scene_ref)
    numbers, cnotes = check_frame(scene, rec)
    ok, table = judge(numbers, cell.limits["numbers"])
    notes.update(check_numbers=numbers, check_s=time.perf_counter() - t,
                 check_notes=cnotes)
    result.update(correct=ok, failed=0 if ok else 1, metrics=metrics)
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": cell.spec["chips"], "memory_peak_bytes": mem}
    if trace:
        result["device"].update(busy_s=ctx.busy_s, window_s=ctx.traced_s)
        result["breakdown"] = breakdown
    result["check"] = table
    return result, notes


def check_frame_index(seed, check_frames):
    """The frame the check holds against the reference, 1-based, drawn
    from the seed among the first `check_frames` of the window (the
    fewest a window of the cell holds; limits/<cell>.json)."""
    return 1 + random.Random(seed).randrange(check_frames)


def program_counters(traffic):
    """The program's counter dict that the traffic file names under
    "counters" ("module:attribute"), whose values the harness zeroes
    before the window and divides by its frames; {} where it names
    none."""
    name = traffic.get("counters")
    if not name:
        return {}
    mod, attr = name.split(":")
    return getattr(importlib.import_module(mod), attr)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m nmcbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    try:
        cell = Cell(args.workload)
        import torch
        # one host thread: the frame is launches from one thread, and idle
        # intra-op workers only take cores from it
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.spec["chips"]:
            raise Refused(f"{args.workload} needs {cell.spec['chips']} CUDA "
                          f"device(s); this machine has "
                          f"{torch.cuda.device_count()}")
        try:
            import nmcfluid_torch  # noqa: F401  (the program under test)
        except ImportError as e:
            raise Refused(f"the program nmcfluid_torch does not import: {e}")
        log(f"card: {card_line()}")
        result, notes = run_cell(cell, args.seed, args.seconds, args.trace,
                                 "cuda", t_start)
        found = forbidden_modules()
        if found:
            raise Refused("the run loaded forbidden modules: "
                          + ", ".join(found))
    except Refused as e:
        log(f"refused: {e}")
        return 2
    report(result, notes)
    return 0


def report(result, notes):
    """Notes on stderr, the numbers compared last there; the result as
    the last line of stdout."""
    log("notes: " + json.dumps(notes, default=str))
    for name, row in result["check"].items():
        log(f"check {name}: {row['value']!r} (limit {row['limit']!r})")
    log(f"check correct: {result['correct']}")
    print(json.dumps(_finite(result)), flush=True)


def _finite(obj):
    """The result with every non-finite number written as a string, so
    that the line is strict JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj
