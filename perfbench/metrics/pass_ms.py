"""pass_ms.<Pass>: the pass's milliseconds in the frames replayed as the
captured frame's chain of per-pass graphs (a CUDA event between each two
passes), the mean over those frames; nothing where the cell has no such
pass."""

import statistics


def read(ctx, part):
    values = ctx.pass_ms.get(part)
    return statistics.fmean(values) if values else None
