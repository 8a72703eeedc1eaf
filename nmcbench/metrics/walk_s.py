"""walk_s: seconds a frame of the walk-on-stars solve, every pressure
chunk (stage_times["wost_solve"]), in the traced window."""


def read(ctx):
    return ctx.stage_s.get("wost_solve")
