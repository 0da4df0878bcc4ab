"""raster.roofline_share: the least time of a frame's rasters (bytes from
``roofline/bounds``, over the peak bandwidth) as a share of the
``raster_tiles_kernel`` device time a frame in the trace; nothing where no
such kernel ran."""

from perfbench.roofline import bounds


def read(ctx, part):
    device_s = ctx.trace.kernel_us("raster_tiles_kernel") * 1e-6 / ctx.frames_traced
    nbytes = bounds.frame_raster_bytes(ctx.config)
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * bounds.least_seconds(nbytes) / device_s
