"""eval_ms: device time of the evaluation a scenario-round (ms).

The kernels launched inside the program's ``dfl:eval`` spans, which wrap
each chunk's metrics in `fl/simulator` (``vmap(_metrics)``: the test-set
forward for accuracy and the train-loss forward over the padded shards).
The time in which any of them ran (kernels that overlap counted once)
over the traced call, over its scenario-rounds.  Nothing where the
program opens no such span.
"""


def read(ctx):
    ops = ctx.trace.launched_in("dfl:eval")
    if not ops or not ctx.scenario_rounds:
        return None
    return ctx.trace.span_us(ops) / 1e3 / ctx.scenario_rounds
