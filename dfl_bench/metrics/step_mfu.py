"""step_mfu: the traced call's model FLOPs over its window, as a share of
the card's peak in the configuration's precision (%).

The FLOPs are the benchmark's own count from shapes
(`flops.scenario_round_flops` of `flops.forward_flops`: local training's
forward and backward, and each round's evaluation forwards, over the
clients' own samples and the test set; a routed term's expected work).
It bounds every kernel's roofline share from above on the whole call.
"""


def read(ctx):
    if (not ctx.peak_flops or not ctx.trace.ops or ctx.trace.window_us <= 0
            or ctx.flops <= 0):
        return None
    seconds = ctx.trace.window_us / 1e6
    return 100.0 * ctx.flops / seconds / ctx.peak_flops
