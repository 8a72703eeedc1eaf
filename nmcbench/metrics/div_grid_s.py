"""div_grid_s: seconds a frame of the divergence grid
(stage_times["div_grid"]), in the traced window."""


def read(ctx):
    return ctx.stage_s.get("div_grid")
