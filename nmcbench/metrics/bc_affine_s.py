"""bc_affine_s: seconds a frame of the hard boundary conditions' affine map
(NeuralFluid.velocity_affine, D + 1 passes a batch), in the pool build and
the head solve, host clock (stage_times["bc_affine"], the program's span),
in the traced window."""


def read(ctx):
    return ctx.stage_s.get("bc_affine")
