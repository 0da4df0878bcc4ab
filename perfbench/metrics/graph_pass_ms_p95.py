"""graph_pass_ms_p95.<Pass>: the 95th percentile (numpy's linear) of the
pass's milliseconds in the whole-frame graph the window replayed, over the
window's frames, from the program's frame record (``lib/records``);
nothing where the program keeps no record, its clock is not the device's,
or the cell has no such pass."""

import numpy as np

from perfbench.lib import records


def read(ctx, part):
    ms = records.window_pass_ms(ctx, part)
    return float(np.percentile(ms, 95)) if ms is not None else None
