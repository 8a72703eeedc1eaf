"""fit_wide_launches: fit-kernel launches a frame that run the 4-point x
4-unit register micro-tiles, the passes of 4,096 outputs (a 32-point tile
at H padded to 128, or two tiles at 64; the program's counter
stage_times["fit_wide_launches"], which its fits also count as 0 where
they take the narrow products or the CPU twin), in the traced window. A
program without the counter gives nothing."""


def read(ctx):
    return ctx.stage_s.get("fit_wide_launches")
