"""mc_frame_s: seconds a frame under the walk-on-stars projection, the
window's wall time (host clock, each frame ending in a device
synchronize) over its whole frames."""


def read(ctx):
    if ctx.traffic["projection"] != "wost":
        return None
    return ctx.window_s / ctx.frames
