"""host_ms.<stage>: the host's milliseconds a frame in the program's zone
``arkose.frame.<stage>`` (camera, fill, replay), the mean over the window's
frames, which ran with no profiler: the zones' wall clock that the frame
record keeps beside each frame's device times (``lib/records``); nothing
where the program keeps no record or the zone did not run in every window
frame."""

import numpy as np

from perfbench.lib import records


def read(ctx, part):
    rows = records.window_rows(ctx)
    ms = None if rows is None else rows["host_ms"].get(f"arkose.frame.{part}")
    if ms is None or not np.isfinite(ms).all():
        return None
    return float(ms.mean())
