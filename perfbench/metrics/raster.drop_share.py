"""raster.drop_share: the bin entries the caps dropped over the entries the
binning wanted (dropped and kept), the camera's and the sun's rasters
together, summed over the window's frames, from the frame record's
``raster.*_dropped`` and ``raster.*_binned``; nothing where the program
keeps no record or bins nothing."""

from perfbench.lib import records


def read(ctx, part):
    rows = records.window_rows(ctx)
    if rows is None:
        return None
    c = rows["counters"]
    names = [f"raster.{r}_{k}" for r in ("camera", "sun") for k in ("dropped", "binned")]
    if any(n not in c for n in names):
        return None
    dropped = float(c["raster.camera_dropped"].sum() + c["raster.sun_dropped"].sum())
    wanted = dropped + float(c["raster.camera_binned"].sum() + c["raster.sun_binned"].sum())
    return 100.0 * dropped / wanted if wanted > 0 else None
