"""graph_pass_ms.<Pass>: the pass's mean milliseconds in the whole-frame
graph the window replayed, over the window's frames: the difference of the
device timestamps the program's frame record holds around the pass
(``lib/records``); nothing where the program keeps no record, its clock
is not the device's, or the cell has no such pass."""

from perfbench.lib import records


def read(ctx, part):
    ms = records.window_pass_ms(ctx, part)
    return float(ms.mean()) if ms is not None else None
