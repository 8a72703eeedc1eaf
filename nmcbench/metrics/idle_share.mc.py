"""idle_share.mc: the device's idle share of the traced slice of a
walk-on-stars frame, in %: the frame run with its walk cut to the first
65,536-point pressure chunk (traffic/wost.json traced_frame), i.e. the
two fits, the divergence grid and one chunk of the walk; 1 - the kernels'
summed own time over the slice's wall time, one torch.profiler window.
A whole frame launches ~1.6 M kernels, too many to reduce within a run."""


def read(ctx):
    if ctx.traffic["projection"] != "wost" or not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s)
