"""pool_build_s: seconds a frame of the phase fits' pool builds, _fused_fit's
loop over the fit_pool batches (points, targets, hard-BC affine map) and
the stack, synchronized (stage_times["pool_build"], the program's span),
in the traced window."""


def read(ctx):
    return ctx.stage_s.get("pool_build")
