"""reads_per_s (end to end, host clock): reads (each mate counts) whose
results are in host memory, over the window's whole time, drain included."""


def read(ctx):
    return ctx.reads / ctx.window["seconds"]
