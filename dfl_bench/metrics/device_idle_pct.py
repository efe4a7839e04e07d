"""device_idle_pct: share of the traced call in which no operation ran on
the device (%): one less the union of the device's kernel, copy and set
intervals over the call's window (the ``dfl:call`` range, extended to the
last device operation it launched)."""


def read(ctx):
    if ctx.trace.window_us <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
