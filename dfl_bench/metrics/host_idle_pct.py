"""host_idle_pct: share of the traced call in which the device sat idle
while the host ran its own phases (%).

The idle gaps of the call's window that fall inside none of the
``dfl:local_train``, ``dfl:exchange`` and ``dfl:eval`` ranges, over the
window: preparing a group (batching, routing, moves to the device),
building its initial rows, the round's draws, the copy of the metrics to
the host, and what lies between groups.  With `train_idle_pct` it splits
`device_idle_pct`.  Nothing where the program opens no ``dfl:prepare``
span of its own.
"""
from dfl_bench import spans

DEVICE_PHASES = ("dfl:local_train", "dfl:exchange", "dfl:eval")


def read(ctx):
    trace = ctx.trace
    if ("dfl:prepare" not in trace.ranges or not trace.ops
            or trace.window_us <= 0):
        return None
    idle = spans.idle_us(trace) - spans.idle_in_us(trace, DEVICE_PHASES)
    return 100.0 * idle / trace.window_us
