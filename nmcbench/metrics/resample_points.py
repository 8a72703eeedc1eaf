"""resample_points: points a frame that the fluid's rejection sampler draws
in its rounds after the first (every point of the batch or group it
redraws, in the pool builds, the head solves and the pressure cloud; the
program's counter stage_times["resample_points"]), in the traced window.
A program without the counter gives nothing."""


def read(ctx):
    return ctx.stage_s.get("resample_points")
