"""exchange_ms: device time of the exchange a scenario-round (ms).

The kernels launched inside the program's ``dfl:exchange`` spans, which
wrap every `core/protocols.dispatch_round_seg` call (`fl/simulator`):
the mask draws' comparisons, eq. 6 through `core/aggregation.apply_mode`
(K1), AaYG's mixes, C-FL's star and the bias diagnostic.  The round's
uniforms are drawn before it, outside the span.  The time in which any of them ran
(kernels that overlap counted once) over the traced call, over its
scenario-rounds.
"""


def read(ctx):
    ops = ctx.trace.launched_in("dfl:exchange")
    if not ops or not ctx.scenario_rounds:
        return None
    return ctx.trace.span_us(ops) / 1e3 / ctx.scenario_rounds
