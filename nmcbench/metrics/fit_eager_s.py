"""fit_eager_s: seconds a frame the two phase fits spend outside the fit
kernel: the pool build, the head solve and the hard BCs
(stage_times advect_fit + project_fit - fit_kernel), in the traced
window."""


def read(ctx):
    s = ctx.stage_s
    if "fit_kernel" not in s:
        return None
    return s.get("advect_fit", 0.0) + s.get("project_fit", 0.0) \
        - s["fit_kernel"]
