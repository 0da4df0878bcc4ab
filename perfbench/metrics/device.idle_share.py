"""device.idle_share: the share of the traced span of whole-frame replays
(first device operation's start to the last one's end) in which no
operation ran on the device."""


def read(ctx, part):
    window = ctx.trace.window_us
    return 100.0 * (1.0 - ctx.trace.busy_us / window) if window > 0 else None
