"""key_draw_s: seconds a frame of the program's key draws (utils/keys.py: the
words on the CPU and the copy to the device), host clock
(stage_times["key_draw"], the program's span), in the traced window."""


def read(ctx):
    return ctx.stage_s.get("key_draw")
