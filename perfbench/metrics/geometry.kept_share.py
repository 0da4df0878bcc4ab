"""geometry.kept_share: the triangles that survive the camera's culling
(the frame record's ``geometry.kept``) over the scene pool's valid
triangles (``geometry.triangles``), summed over the window's frames;
nothing where the program keeps no record or counts no triangle."""

from perfbench.lib import records


def read(ctx, part):
    rows = records.window_rows(ctx)
    if rows is None:
        return None
    kept = rows["counters"].get("geometry.kept")
    pool = rows["counters"].get("geometry.triangles")
    if kept is None or pool is None or pool.sum() <= 0:
        return None
    return 100.0 * float(kept.sum()) / float(pool.sum())
