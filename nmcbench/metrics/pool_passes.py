"""pool_passes: grouped passes a frame of the phase fits' pool builds
(_build_pool, one pass a group of fit batches; the program's counter
stage_times["pool_passes"]), in the traced window. A program that builds
its pools without the counter gives nothing."""


def read(ctx):
    return ctx.stage_s.get("pool_passes")
