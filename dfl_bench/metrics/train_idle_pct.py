"""train_idle_pct: share of the traced call in which the device sat idle
inside local training (%).

The idle gaps of the call's window (as `device_idle_pct` finds them) that
fall inside ``dfl:local_train`` ranges, over the window: local training
that the host's launches pace (the LSTM's Python loop of small kernels).
"""
from dfl_bench import spans


def read(ctx):
    trace = ctx.trace
    if ("dfl:local_train" not in trace.ranges or not trace.ops
            or trace.window_us <= 0):
        return None
    idle = spans.idle_in_us(trace, ("dfl:local_train",))
    return 100.0 * idle / trace.window_us
