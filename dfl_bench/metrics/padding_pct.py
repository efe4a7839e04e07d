"""padding_pct: share of local training's sample passes spent on padding
(%).

The program counts, for every gradient evaluation, the rows it computes
(each client's shard tiled to the largest) and the clients' own samples
among them (`fl/simulator.SAMPLE_PASSES`); this is the rest over the
rows computed.  Every call of a cell has the same shapes, so the
process's whole count gives the traced call's share.  Nothing where the
program keeps no such count, or the trace holds no local training or no
device operation (a run off the card).
"""


def read(ctx):
    if "dfl:local_train" not in ctx.trace.ranges or not ctx.trace.ops:
        return None
    from repro_torch.fl import simulator

    counts = getattr(simulator, "SAMPLE_PASSES", None) or {}
    computed = counts.get("computed", 0)
    if computed <= 0:
        return None
    return 100.0 * (computed - counts.get("own", 0)) / computed
