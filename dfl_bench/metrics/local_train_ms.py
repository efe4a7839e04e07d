"""local_train_ms: device time of local training a scenario-round (ms).

The kernels launched inside the program's ``dfl:local_train`` spans,
which wrap every call of the gradients that `fl/simulator.build_sim`
binds (`torch.func.vmap(torch.func.grad(...))`, or one `torch.func.grad`
a client on the conv path): the model's forward and backward in
`models/smallnets`.  The GD update (``rows - lr * g``) runs outside the
span.  The time in which any of them ran (kernels that overlap counted
once) over the traced call, over its scenario-rounds.
"""


def read(ctx):
    ops = ctx.trace.launched_in("dfl:local_train")
    if not ops or not ctx.scenario_rounds:
        return None
    return ctx.trace.span_us(ops) / 1e3 / ctx.scenario_rounds
