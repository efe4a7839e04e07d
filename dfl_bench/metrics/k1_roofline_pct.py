"""k1_roofline_pct: K1's share of its bytes bound (%).

K1 is `kernels/csrc/ra_aggregate.cu` (`ra_reg_kernel` for N <= 16,
`ra_smem_kernel` above).  Its bound is the time to read each input once
and write the output once at the card's HBM bandwidth, from the
(B, N, L, K) shape of every launch of the traced call
(`kernels/ra_aggregate.SHAPE_LAUNCHES`): the segments w (B, N, L, K) in
the configuration's precision, the packed-bool success mask
e (B, N, N, L), the weights p (N,) in float32 (one vector shared by the
batch, as a grid's round passes it), and the output (B, N, L, K).  The
time is K1's kernels' device time in the trace.
"""
import re

PATTERN = re.compile(r"ra_(reg|smem)_kernel")


def launch_bytes(b, n, l, k, value_bytes):
    """Bytes a launch must move at least."""
    return 2 * b * n * l * k * value_bytes + b * n * n * l + 4 * n


def read(ctx):
    ops = [op for op in ctx.trace.ops if PATTERN.search(op.name)]
    seconds = sum(op.dur for op in ops) / 1e6
    if seconds <= 0 or not ctx.k1_launches or not ctx.peak_bytes_per_s:
        return None
    moved = sum(count * launch_bytes(*shape, ctx.value_bytes)
                for shape, count in ctx.k1_launches.items())
    return 100.0 * moved / ctx.peak_bytes_per_s / seconds
