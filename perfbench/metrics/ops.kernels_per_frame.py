"""ops.kernels_per_frame: device kernels a frame, counted in the profiler's
trace of the whole-frame replays."""


def read(ctx, part):
    return len(ctx.trace.kernels) / ctx.frames_traced if ctx.trace.kernels else None
