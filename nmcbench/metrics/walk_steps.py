"""walk_steps: walk steps a frame, the generation executor's own count
(nmcfluid_torch/wost/gen.py counts["steps"]) over the traced window's
frames. An exact count: a change that shortens the walks moves it."""


def read(ctx):
    if ctx.traffic["projection"] != "wost":
        return None
    return ctx.counts.get("steps") or None
