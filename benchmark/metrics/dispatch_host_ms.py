"""dispatch_host_ms (app loop, host clock): mean host time of one
batch's dispatch call with its copies enqueued, over the measured
window's batches of the traced run."""


def read(ctx):
    d = ctx.window["dispatch_s"]
    return 1e3 * sum(d) / len(d) if d else None
