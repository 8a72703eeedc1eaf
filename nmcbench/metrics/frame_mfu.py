"""frame_mfu: the whole frame's share of the chip's float32 peak, in %:
the SIREN's operations the frame needs (yardstick/work.py::frame_flops:
the fits' iterations, the pools' and head solves' forward passes, the
divergence grid) over 67 TFLOP/s times the traced window's seconds a
frame, under a deterministic projection. Stated against the published
peak of a 700 W card: the run's stderr gives the card's power limit."""
from nmcbench.yardstick.peaks import F32_FLOPS
from nmcbench.yardstick.work import frame_flops


def read(ctx):
    if ctx.traffic["projection"] == "wost":
        return None
    return 100.0 * frame_flops(ctx.cfg) / (F32_FLOPS * ctx.window_s
                                           / ctx.frames)
