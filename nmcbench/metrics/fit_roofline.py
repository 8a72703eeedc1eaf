"""fit_roofline: the fit kernel's share of its roofline, in %: the least
time of a frame's two phase fits (max_n_iters Adam iterations each, the
bytes and operations of yardstick/work.py::iteration_work at the
configuration's shapes, against 3.35 TB/s and 67 TFLOP/s float32) over
the kernel's own time a frame (the program's stage_times["fit_kernel"],
CUDA events around its launches), in the traced window."""
from nmcbench.yardstick.peaks import bound_ms
from nmcbench.yardstick.work import fit_work


def read(ctx):
    t = ctx.stage_s.get("fit_kernel")
    if not t:
        return None
    ms, _ = bound_ms(*fit_work(ctx.cfg))
    return 100.0 * ms * 1e-3 / t
