"""setup_s: seconds from the process's start to the first timed frame:
imports, the fit kernel's library (built by nvcc on a checkout's first
run, loaded after), the scene and the fluid, the start weights, and the
warm-up frame. Host clock."""


def read(ctx):
    return ctx.setup_s
