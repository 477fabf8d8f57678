"""setup_s (end to end, host clock): process start to the first timed
batch: genome and reads made from the seed, the index build, the upload
and the warm-up batches (kernel builds too, in a checkout's first run)."""


def read(ctx):
    return ctx.setup_s
