"""Named spans of the port's host work: the one timer of the program.

A fluid's public entry points (`NeuralFluid.step`, `add_source`) bind a
sink for their duration (`bound`): the fluid's `stage_times` dict when its
`profile` is on, else none. A span (`span(name)`) then

- when nothing is bound and no torch profiler is running (tracing off),
  costs one check of a module-level value: it reads no clock, opens no
  profiler range and never synchronizes;
- when a sink is bound, adds its host-clock seconds to `sink[name]`; with
  a CUDA `device` it synchronizes that device at both ends first, so the
  seconds hold the device work it queued (the stages of
  `NeuralFluid._timed`, the pool build and the head solve); without one
  it reads the host clock only;
- when a torch profiler was running as the entry point began, opens
  `torch.profiler.record_function("stage:" + name)`, with or without a
  sink, so the program's spans share the profiler's clock with the CUDA
  kernels and a trace can label each idle gap of the device by the
  innermost span that held it.

A counter (`count(name, n)`) adds n to `sink[name]` while a sink is
bound, and does nothing else.

The spans, each summed over every fit of a frame (source_fit,
advect_fit(2), project_fit(2)) or its projections, beside the stages of
`_timed`:

    pool_build   _fused_fit's grouped passes over the fit_pool batches
                 (_build_pool; synchronized)
    head_solve   _ls_head_solve, whole (synchronized)
    fit_targets  the target part of each phase batch, after its points
                 are drawn (host clock)
    bc_affine    the hard-BC affine map, NeuralFluid.velocity_affine
                 (host clock)
    key_draw     each draw of utils.keys.Key, or of a KeyGroup of them:
                 the CPU words and the copy to the device (host clock)
    obstacle_modes
                 the spectral solve's modal correction of an obstacle
                 (circle, cylinder or sphere): its fit to the box
                 solve's Neumann residual and its evaluation at the
                 pressure cloud (synchronized; nested in spectral_solve)

and the counters

    pool_passes  the pool builds' grouped passes
    resample_points
                 the points sim/sampling.py::fluid_points draws in its
                 rounds after the first (scenes with an obstacle; 0 where
                 one round filled every slot)

fit_targets, bc_affine and key_draw nest inside the other two and also
count the head solve's ls_head + 1 batches, so the pool's own points take
about pool_build - fit_targets - bc_affine (the head solve's share is
ls_head + 1 batches against fit_pool). key_draw cuts across all of them.
No span log is kept: the timeline belongs to the profiler, the totals to
the sink. Spans opened on other threads (the points mesh's walks) add to
the same totals.
"""
import contextlib
import time

import torch

# (sink or None, profiler running) of the entry point running now; None
# when tracing is off
_state = None
_OFF = contextlib.nullcontext()

# what a span calls, looked up at call time
_clock = time.perf_counter
_sync = torch.cuda.synchronize
_range = torch.profiler.record_function


def _profiling():
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


@contextlib.contextmanager
def bound(sink):
    """Bind `sink` (a dict, or None) for the duration of the block, and
    the profiler's state as the block begins."""
    global _state
    prev, profiling = _state, _profiling()
    _state = (sink, profiling) if sink is not None or profiling else None
    try:
        yield
    finally:
        _state = prev


def count(name, n=1):
    """Add n to the bound sink's `name`; nothing while no sink is bound."""
    if _state is not None and _state[0] is not None:
        _state[0][name] = _state[0].get(name, 0) + n


def span(name, device=None):
    """The span `name` (a context manager); `device` synchronizes it
    while a sink is bound (see the module docstring)."""
    if _state is None:
        return _OFF
    return _Span(name, device)


class _Span:
    __slots__ = ("name", "sink", "device", "rng", "t0")

    def __init__(self, name, device):
        self.name = name
        self.sink, profiling = _state
        self.device = device if (self.sink is not None and device is not None
                                 and device.type == "cuda") else None
        self.rng = _range("stage:" + name) if profiling else None

    def __enter__(self):
        if self.rng is not None:
            self.rng.__enter__()
        if self.sink is not None:
            if self.device is not None:
                _sync(self.device)
            self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            if self.device is not None:
                _sync(self.device)
            self.sink[self.name] = (self.sink.get(self.name, 0.0)
                                    + _clock() - self.t0)
        if self.rng is not None:
            self.rng.__exit__(*exc)
        return False
