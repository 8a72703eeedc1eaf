"""obstacle_modes_s: seconds a frame of the obstacle's modal correction in
the spectral solve (the circle's modes fitted to the box solve's Neumann
residual and evaluated at the pressure cloud), synchronized
(stage_times["obstacle_modes"], the program's span, nested in
spectral_solve), in the traced window. A program without the span gives
nothing."""


def read(ctx):
    return ctx.stage_s.get("obstacle_modes")
