"""loop.host_ms: the host's milliseconds inside ``Renderer.render_frame``
(the camera's state, the per-frame inputs' upload and the graph's launch),
the mean over the window's frames; the wait for frame n-2 is outside it."""

import statistics


def read(ctx, part):
    return statistics.fmean(ctx.host_ms) if ctx.host_ms else None
