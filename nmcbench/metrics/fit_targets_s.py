"""fit_targets_s: seconds a frame of the fit batches' targets (the back-trace
through the previous network, or u_prev - grad p), in the pool build and
the head solve, host clock (stage_times["fit_targets"], the program's
span), in the traced window."""


def read(ctx):
    return ctx.stage_s.get("fit_targets")
