#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (arkoserenderer_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a
result line):
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off;
  2. build: compiles the hand-written kernels from csrc/ with nvcc and
     prints ptxas's registers, shared memory and spills (none allowed);
  3. kernel against its plain torch version on the card, vis and depth
     equal bit for bit: the random 64x64 cases, the y_offset band and the
     depth_limit peel, an adversarial case (vertices on pixel centres and
     tile borders, slivers, zero area, near-clipped huge triangles,
     duplicated coplanar triangles with lists longer than one staging
     window), the 1080p camera raster and the 8192^2 sun raster; and the
     wrapper's ValueError for a tile the kernel does not take. For the
     camera and the sun it prints the kernel's time as the frame calls it
     (``ms``: CUDA events around back-to-back wrapper calls), its device
     time (``device_ms``: a CUDA graph of launches through the C entry
     point), the plain version's time, the pixel tests before and after
     exact tile rejection, the bound and its kind, and the share of the
     bound;
  4. the 256^2 forward golden (tests/goldens/forward.png) rendered on the
     card, under the golden test's thresholds;
  5. the forward frame at 1920x1080 with an 8192^2 shadow map: 20 frames,
     finite LDR, non-empty coverage, raster kernel launched frames + 1
     times (camera every frame, sun once under the static shadow cache);
     prints ms/frame, a per-pass table and peak device memory.
The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FRAMES, WARMUP = 20, 4
TPU_KERNEL = "arkoserenderer_tpu/ops/raster_pallas.py:63"
KERNEL_SOURCE = "arkoserenderer_torch/csrc/raster_tiles.cu"


def random_case(rng, n, big: bool, width: int, height: int):
    """The test_raster_pallas.py cases: n random triangles (+ a huge floor)."""
    from arkoserenderer_torch.core import mathx as mx

    centers = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(-10, -2, n)], -1
    )
    verts = (centers[:, None] + rng.normal(size=(n, 3, 3)) * 0.8).reshape(-1, 3)
    if big:
        verts = np.concatenate([verts, [[-50, -1, 50], [50, -1, 50], [0, -1, -50]]])
    verts = verts.astype(np.float32)
    proj = mx.perspective_reverse_z(np.radians(70.0), width / height, 0.1, 100.0)
    clip = np.concatenate(
        [verts @ proj[:3, :3].T + proj[:3, 3], (verts @ proj[3, :3] + proj[3, 3])[:, None]], -1
    ).astype(np.float32)
    idx = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return torch.from_numpy(clip), torch.from_numpy(idx)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    from arkoserenderer_torch.assets.procedural import build_test_scene
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops import raster
    from arkoserenderer_torch.ops.raster_cuda import (
        build_kernels,
        ptxas_report,
        rasterize_tiles_cuda,
    )
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_torch.tools import raster_bench as rb
    from arkoserenderer_torch.utils.imageio import load_png, to_u8

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = rb.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    lib = build_kernels()
    print(f"build: raster_tiles.cu built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    report = ptxas_report(lib)
    for line in report:
        print(f"  {line}")
    spills = [line for line in report if re.search(r"[1-9]\d* bytes spill", line)]
    if spills:
        raise AssertionError(f"ptxas spills registers: {spills}")

    # -- 3. kernel against the plain version --------------------------------------
    def compare(label, setup, bins, width, height, cfg, depth_only=False, y_offset=0,
                depth_limit=None):
        kw = dict(depth_only=depth_only, y_offset=y_offset, depth_limit=depth_limit)
        kv, kd = rasterize_tiles_cuda(setup, bins, width, height, cfg, **kw)
        pv, pd = raster.rasterize_tiles_plain(setup, bins, width, height, cfg, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(kv, pv) and torch.equal(kd, pd)):
            raise AssertionError(
                f"{label}: kernel != plain (vis mismatches {(kv != pv).sum().item()}, "
                f"depth max diff {(kd - pd).abs().max().item()})")
        if not bool((kd > 0).any()):
            raise AssertionError(f"{label}: the raster covers no pixel")
        print(f"kernel==plain {label}: equal, coverage {(kd > 0).float().mean().item():.4f}, "
              f"max tri/tile {int(bins.counts.max())}, global {int(bins.global_count)}",
              flush=True)
        return (kd - pd).abs().max().item(), pd

    rng = np.random.default_rng(1234)
    small = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64, max_global_tris=32)
    errs = []
    for label, n, big, w_eps, cfg in (
        ("random 64x64", 60, False, 1e-4, small),
        ("global-list 64x64", 20, True, 0.1,
         RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64, max_tiles_per_tri=4,
                      max_global_tris=32)),
    ):
        clip, idx = random_case(rng, n, big, 64, 64)
        valid = torch.ones(len(idx), dtype=torch.bool)
        setup = raster.setup_triangles(clip.to(dev), idx.to(dev), valid.to(dev), 64, 64,
                                       cull_backfaces=False, w_eps=w_eps)
        bins = raster.bin_triangles(setup, 64, 64, cfg)
        for depth_only in (False, True):
            errs.append(compare(f"{label} depth_only={depth_only}", setup, bins, 64, 64, cfg,
                                depth_only)[0])
        if not big:
            # The band (rows 16..47) and the peel below the first layer, as
            # tests/test_torch_kernels.py runs them.
            band = raster.bin_triangles(setup, 64, 32, cfg, y_offset=16)
            errs.append(compare(f"{label} band y_offset=16", setup, band, 64, 32, cfg,
                                y_offset=16)[0])
            first = raster.rasterize_tiles_plain(setup, bins, 64, 64, cfg)[1]
            errs.append(compare(f"{label} peel depth_limit", setup, bins, 64, 64, cfg,
                                depth_limit=first)[0])

    clip, idx = rb.adversarial_case()
    adv_cfg = rb.ADVERSARIAL_CFG
    setup = raster.setup_triangles(clip.to(dev), idx.to(dev),
                                   torch.ones(len(idx), dtype=torch.bool, device=dev), 64, 64,
                                   cull_backfaces=False, w_eps=0.1)
    bins = raster.bin_triangles(setup, 64, 64, adv_cfg)
    err, first = compare("adversarial 64x64", setup, bins, 64, 64, adv_cfg)
    errs.append(err)
    errs.append(compare("adversarial 64x64 depth_only", setup, bins, 64, 64, adv_cfg,
                        depth_only=True)[0])
    errs.append(compare("adversarial 64x64 peel depth_limit", setup, bins, 64, 64, adv_cfg,
                        depth_limit=first)[0])
    band = raster.bin_triangles(setup, 64, 32, adv_cfg, y_offset=16)
    errs.append(compare("adversarial 64x64 band y_offset=16", setup, band, 64, 32, adv_cfg,
                        y_offset=16)[0])
    wide = RasterConfig(tile_h=64, tile_w=64)
    try:
        rasterize_tiles_cuda(setup, raster.bin_triangles(setup, 64, 64, wide), 64, 64, wide)
    except ValueError as e:
        print(f"tile 64x64 refused on the card: {e}", flush=True)
    else:
        raise AssertionError("the raster kernel took a 64x64 tile, outside check_tile's rule")

    W, H, S = 1920, 1080, 8192
    full_raster = RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256)
    full_cfg = PipelineConfig(width=W, height=H, raster=full_raster, shadow_map_size=S)
    scene, cam = build_test_scene(viewport=(W, H))
    r = Renderer(scene, cam, full_cfg, device=dev, taa=False, bloom=False)
    cases = rb.forward_raster_inputs(r.scene_arrays, cam.state(0, dev), r.cfg.scene, W, H, S,
                                     full_raster)
    timed = {}
    for name, label, p_iters in (("camera", f"camera {W}x{H}", 5),
                                 ("sun", f"sun {S}x{S} depth-only", 2)):
        setup, bins, w, h, depth_only = cases[name]
        errs.append(compare(label, setup, bins, w, h, full_raster, depth_only)[0])
        device_ms = rb.kernel_ms(lib, setup, bins, w, h, full_raster, depth_only)
        k_ms = rb.events_ms(lambda: rasterize_tiles_cuda(setup, bins, w, h, full_raster,
                                                         depth_only=depth_only),
                            rb.WRAPPER_CALLS[name])
        p_ms = rb.events_ms(lambda: raster.rasterize_tiles_plain(setup, bins, w, h, full_raster,
                                                                 depth_only=depth_only), p_iters)
        before, after = rb.pixel_tests(setup, bins, w, h, full_raster)
        bound, kind = rb.bound_ms(setup, bins, w, h, depth_only, after)
        timed[name] = dict(ms=k_ms, device_ms=device_ms, plain_ms=p_ms, bound_ms=bound,
                           bound_by=kind)
        counts, px = bins.counts.float(), full_raster.tile_h * full_raster.tile_w
        print(f"{label}: {counts.numel()} tiles, {int(counts.sum())} binned pairs (mean "
              f"{counts.mean().item():.4f}, max {int(counts.max())} a tile), "
              f"{int(bins.global_count)} global; (tile, triangle) pairs walked "
              f"{before // px} before rejection, {after // px} after", flush=True)
        print(f"{label}: kernel {k_ms:.4f} ms (wrapper, CUDA events), {device_ms:.4f} ms "
              f"(device, CUDA graph), plain {p_ms:.4f} ms; pixel tests {before} before "
              f"rejection, {after} after; bound {bound:.4f} ms ({kind}), "
              f"{bound / device_ms:.1%} of the bound on device time, {bound / k_ms:.1%} on "
              f"the wrapper's [{card}]", flush=True)
    del cases, setup, bins

    # -- 4. golden on the card ----------------------------------------------------
    g_cfg = PipelineConfig(width=256, height=256,
                           raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                           shadow_map_size=256)
    g_scene, g_cam = build_test_scene(viewport=(256, 256))
    img = Renderer(g_scene, g_cam, g_cfg, device=dev, taa=False, bloom=False).render_frame()
    golden = load_png(str(ROOT / "tests" / "goldens" / "forward.png"))[..., :3]
    diff = np.abs(to_u8(img.cpu().numpy()).astype(int) - golden.astype(int))
    if not (diff.mean() < 1.5 and (diff > 24).mean() < 0.005):
        raise AssertionError(f"golden: mean abs diff {diff.mean():.4f}, "
                             f"{(diff > 24).mean():.4%} pixels off by > 24")
    print(f"golden forward 256x256 on the card: mean abs diff {diff.mean():.4f} (< 1.5), "
          f"{(diff > 24).mean():.4%} pixels off by > 24 (< 0.5%)", flush=True)

    # -- 5. the slice at full size --------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rasterize_tiles_cuda.launches = 0
    bench = r.benchmark(warmup=WARMUP, iters=FRAMES - WARMUP)
    launches = rasterize_tiles_cuda.launches
    ldr = r.state["LDR"]
    if tuple(ldr.shape) != (H, W, 3) or not bool(torch.isfinite(ldr).all()):
        raise AssertionError("full-size LDR is not a finite (H, W, 3) image")
    coverage = r.state["SceneCoverage"].float().mean().item()
    if coverage <= 0.0:
        raise AssertionError("full-size frame covers no pixel")
    if launches != FRAMES + 1:
        raise AssertionError(f"raster kernel launched {launches} times in {FRAMES} frames, "
                             f"expected {FRAMES + 1}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"forward {W}x{H} shadow {S}: {FRAMES} frames, median {bench['ms_per_frame']:.4f} "
          f"ms/frame over the last {FRAMES - WARMUP} (CUDA events), coverage {coverage:.4f}, "
          f"raster launches {launches}, peak memory {peak / 2**30:.3f} GiB [{card}]", flush=True)
    print(f"frame ms: {[round(x, 4) for x in bench['frame_ms']]}")
    print(f"per-pass median ms [{card}]:")
    for name, ms in bench["pass_ms"].items():
        print(f"  {name:20s} {ms:10.4f}")
    print(f"  {'sum of passes':20s} {sum(bench['pass_ms'].values()):10.4f}", flush=True)

    cam_t, sun_t = timed["camera"], timed["sun"]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "raster_tiles", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": max(errs),
        **cam_t, "library_ms": None, "shape": f"camera {W}x{H}, tile 8x128",
        **{f"sun_{k}": v for k, v in sun_t.items()}, "sun_shape": f"{S}x{S} depth-only",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
