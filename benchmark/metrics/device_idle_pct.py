"""device_idle_pct (device, device trace): share of the traced window in
which no operation ran on the card."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
