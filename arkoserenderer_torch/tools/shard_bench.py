"""Pixel-band sharding on the card: one run of a ``BandJob`` in every rank,
measured (chip_smoke.py phase 20 drives it through ``run_bands``).

``rank_run(band, job, iters)`` is the rank function. Each rank:

  * zeroes the kernels' launch counts, renders ``job.frames`` frames of its
    ``ShardedRenderer`` (the main path), and reads the counts and its peak
    device memory; rank 0 keeps the gathered LDR of the last of them.
    Every raster of the run is captured (``raster_bench.capture_raster_calls``),
    and in the last frame every trace (``trace_bench.capture_calls``) and
    the input of every ``band_rows`` cut, hashed: the cut's input is a
    stage every rank computes alike from gathered planes (the RT
    denoisers), so its bytes must be equal on all ranks, as must the
    replicated state (the DDGI atlases, the gathered sun map and its
    moments), hashed after that frame;
  * holds each captured raster against ``rasterize_tiles_plain`` and each
    trace against ``trace_wide_plain`` bit for bit (the last rank, whose
    band holds the floor, also times its traces, ``trace_bench.measure``);
  * times ``iters`` more frames (``Renderer.benchmark``: CUDA events), the
    band group's collectives in them and the bytes they gathered.

Rank 0 returns every rank's record (``all_gather_object``) and the LDR.
Over N cards: ``run_bands(rank_run, N, "nccl", None, job, iters)``.
"""

from __future__ import annotations

import hashlib

import torch
import torch.distributed as dist

from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.ops import bvh_cuda, raster, raster_cuda
from arkoserenderer_torch.parallel.sharded import BandJob, ShardedRenderer
from arkoserenderer_torch.rendering.pipeline import PipelineConfig
from arkoserenderer_torch.tools import raster_bench as rb
from arkoserenderer_torch.tools import trace_bench as tb
from arkoserenderer_torch.tools.bench import build_scene

# The persistent resources every rank holds whole, hashed after a frame.
REPLICATED = ("ShadowMap.sun", "ShadowMoments.sun", "DDGI.irradiance", "DDGI.visibility",
              "DDGI.offsets")


def bench_scene(name: str, cfg: PipelineConfig):
    """(scene, camera) of the bench's frame kind ``name`` at ``cfg``: a
    ``BandJob.make_scene`` (``functools.partial(bench_scene, name, cfg)``).
    The job's ``pipeline_kw`` names the kind's flags itself."""
    scene, camera, _, _ = build_scene(name, cfg=cfg)
    return scene, camera


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def check_rasters(calls: list, cfg: RasterConfig) -> list[dict]:
    """Each captured raster against its plain version, bit for bit."""
    out = []
    for c in calls:
        kw = dict(depth_only=c["depth_only"], y_offset=c["y_offset"],
                  depth_limit=c["depth_limit"])
        args = (c["setup"], c["bins"], c["width"], c["height"], cfg)
        kv, kd = raster_cuda.rasterize_tiles_cuda(*args, **kw)
        pv, pd = raster.rasterize_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(kv, pv) and torch.equal(kd, pd)):
            raise AssertionError(
                f"band raster {c['height']}x{c['width']} at y_offset {c['y_offset']}: kernel != "
                f"plain (vis {(kv != pv).sum().item()}, depth max diff "
                f"{(kd - pd).abs().max().item()})")
        out.append({"shape": [c["height"], c["width"]], "depth_only": c["depth_only"],
                    "y_offset": c["y_offset"], "coverage": (kd > 0).float().mean().item()})
    return out


def rank_run(band, job: BandJob, iters: int) -> dict | None:
    """The rank function of ``run_bands(rank_run, n, backend, devices, job,
    iters)``; see the module's docstring."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = band.device
    scene, camera = job.scene()
    renderer = ShardedRenderer(scene, camera, job.cfg, band, **job.pipeline_kw)
    kernel, trace = raster_cuda.rasterize_tiles_cuda, bvh_cuda.trace_rays_cuda

    # The main path, its counts set to 0 just before: every raster captured,
    # the last frame's traces captured and its band cuts hashed.
    cuts = []
    band_rows = band.band_rows

    def hashed_cut(x):
        cuts.append(digest(x))
        return band_rows(x)

    def main_path():
        renderer.render_frames(job.frames - 1)
        band.band_rows = hashed_cut
        try:
            return tb.capture_calls(renderer.render_frame)
        finally:
            del band.band_rows

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.launches = 0
    kernel.launches_by_shape.clear()
    trace.launches = 0
    trace.launches_by_label.clear()
    rasters, traces = rb.capture_raster_calls(main_path)
    rec = {
        "rank": band.rank, "backend": band.backend, "device": str(dev),
        "frames": job.frames, "raster_launches": kernel.launches,
        "raster_launches_by_shape": {f"{h}x{w}{' depth-only' if d else ''}": n
                                     for (h, w, d), n in kernel.launches_by_shape.items()},
        "trace_launches_by_label": dict(trace.launches_by_label),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "finite": bool(torch.isfinite(renderer.state["LDR"]).all()),
        "cuts": cuts,
        "replicated": {k: digest(renderer.state[k]) for k in REPLICATED
                       if k in renderer.state},
    }
    ldr = renderer.gather_frame().cpu().numpy()

    # Every raster and the last frame's traces against their plain versions.
    rec["rasters_equal"] = check_rasters(rasters, renderer.cfg.raster)
    del rasters
    rec["traces_equal"] = []
    rec["traces_measured"] = []
    for case in traces:
        case["trace"] = case["label"]
        if band.rank == band.size - 1:
            res = tb.measure(case["bvh"], case)
            rec["traces_measured"].append(res)
        else:
            res = tb.checked(case["bvh"], case)
        rec["traces_equal"].append({"label": case["label"], "rays": res["rays"],
                                    "hit_share": res["hit_share"]})
    del traces

    # Times: iters frames under CUDA events, and the collectives in them.
    band.collective_ms = []
    band.gathered_bytes = 0
    timed = renderer.benchmark(warmup=1, iters=iters)
    coll = band.collective_times()
    per_frame = len(coll) / (iters + 1)
    rec.update(ms_per_frame=timed["ms_per_frame"], wall_ms_per_frame=timed["wall_ms_per_frame"],
               collectives_per_frame=per_frame,
               collective_ms_per_frame=sum(coll) / (iters + 1),
               gathered_mib_per_frame=band.gathered_bytes / (iters + 1) / 2**20)
    band.collective_ms = None

    records = [None] * band.size
    dist.all_gather_object(records, rec)
    if band.rank != 0:
        return None
    return {"ranks": records, "ldr": ldr}
