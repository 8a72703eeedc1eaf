"""head_solve_s: seconds a frame of the phase fits' closed-form head solves
(_ls_head_solve, whole), synchronized (stage_times["head_solve"], the
program's span), in the traced window."""


def read(ctx):
    return ctx.stage_s.get("head_solve")
