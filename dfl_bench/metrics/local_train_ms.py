"""local_train_ms: device time of local training a scenario-round (ms).

The kernels launched inside the benchmark's ``dfl:local_train`` ranges,
which wrap every call of the gradient that `fl/simulator.build_sim`
binds (`torch.func.vmap(torch.func.grad(...))`): the model's forward and
backward in `models/smallnets`.  The GD update (``rows - lr * g``) runs
outside the range.  The time in which any of them ran (kernels that
overlap counted once) over the traced call, over its scenario-rounds.
"""


def read(ctx):
    ops = ctx.trace.launched_in("dfl:local_train")
    if not ops or not ctx.scenario_rounds:
        return None
    return ctx.trace.span_us(ops) / 1e3 / ctx.scenario_rounds
