"""device_ops_per_batch (device pipeline, device trace): kernels, copies
and fills on the card in the traced window, per batch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.traced_batches
