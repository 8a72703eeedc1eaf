"""idle_share.frame: the device's idle share of one whole frame under a
deterministic projection, in %: 1 - the kernels' summed own time
(yardstick/devtrace.py, as device_busy) over the frame's wall time, from
one torch.profiler window over a frame after the traced window."""


def read(ctx):
    if ctx.traffic["projection"] == "wost" or not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s)
