"""mc_frame_mfu: the whole walk-on-stars frame's share of the chip's
float32 peak, in %: the SIREN's operations of yardstick/work.py::
frame_flops (the walk reads the divergence grid and adds none) over 67
TFLOP/s times the traced window's seconds a frame."""
from nmcbench.yardstick.peaks import F32_FLOPS
from nmcbench.yardstick.work import frame_flops


def read(ctx):
    if ctx.traffic["projection"] != "wost":
        return None
    return 100.0 * frame_flops(ctx.cfg) / (F32_FLOPS * ctx.window_s
                                           / ctx.frames)
