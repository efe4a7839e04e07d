"""layout_pct: share of local training's device time in layout kernels (%).

Layout kernels move data without computing: cuDNN's NCHW <-> NHWC
transposes and ATen's copies and transposes (`.contiguous()` of a
permuted or vmapped view).  Matched by name in the kernels launched in
the ``dfl:local_train`` ranges.
"""
import re

PATTERN = re.compile(r"nchwToNhwc|nhwcToNchw|direct_copy_kernel|transpose",
                     re.IGNORECASE)


def read(ctx):
    ops = ctx.trace.launched_in("dfl:local_train")
    total = sum(op.dur for op in ops)
    if total <= 0:
        return None
    return 100.0 * sum(op.dur for op in ops if PATTERN.search(op.name)) / total
