"""spectral_solve_s: seconds a frame of the cosine-transform pressure
solve (stage_times["spectral_solve"]), in the traced window."""


def read(ctx):
    return ctx.stage_s.get("spectral_solve")
