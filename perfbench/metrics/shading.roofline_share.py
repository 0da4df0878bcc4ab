"""shading.roofline_share: the least time of a frame's packed deferred
shading, as a share of the ``packed_shading_kernel`` device time a frame in
the trace; nothing where no such kernel ran.

The least time is the pass's compulsory bytes over the peak bandwidth: each
pixel's visibility id read once (4 bytes) and its G-buffer written once (61:
SceneColor 12, SceneNormal 12, SceneVelocity 8, SceneBaseColor 12,
SceneMaterial 16, SceneCoverage 1), at the configuration's width and
height. The gathers (records, texels, shadow taps) are left out, so the
share cannot pass 100 %."""

from perfbench.roofline import bounds

PIXEL_BYTES = 4 + 12 + 12 + 8 + 12 + 16 + 1


def read(ctx, part):
    device_s = ctx.trace.kernel_us("packed_shading_kernel") * 1e-6 / ctx.frames_traced
    if device_s <= 0:
        return None
    nbytes = int(ctx.config["width"]) * int(ctx.config["height"]) * PIXEL_BYTES
    return 100.0 * bounds.least_seconds(nbytes) / device_s
