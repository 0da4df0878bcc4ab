"""device_idle.<stage>: the share of the traced span (first device
operation's start to the last one's end) in which no operation ran on the
device while the host's innermost program span was ``arkose.frame.<stage>``
(fill, replay); with the idle time under other spans or none it adds up to
``device.idle_share``. Nothing where the trace holds no such span."""

from perfbench.lib import records


def read(ctx, part):
    name = f"arkose.frame.{part}"
    window = ctx.trace.window_us
    if window <= 0 or not any(n == name for _, _, n in records.program_spans(ctx.trace)):
        return None
    return 100.0 * records.idle_us_under(ctx.trace, name) / window
