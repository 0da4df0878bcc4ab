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
  5. the forward slice (no TAA, no Bloom) at 1920x1080 with an 8192^2
     shadow map: 20 frames, finite LDR, non-empty coverage, raster kernel
     launched frames + 1 times (camera every frame, sun once under the
     static shadow cache); prints ms/frame, a per-pass table and peak
     device memory;
  6. the 256^2 full_post golden (tests/goldens/full_post.png: SSAO, motion
     blur, Bloom and TAA over three frames) rendered on the card, under the
     golden test's thresholds;
  7. the depth-only 512^2 local-shadow raster of the test_spot scene's spot
     light: kernel equal to its plain version bit for bit, timed like the
     camera and the sun;
  8. through arkoserenderer_torch.tools.bench, at 1920x1080 with the 8192^2
     sun map and a camera that moves every frame: the forward (TAA +
     Bloom), full_post, bindless (256 materials, 64 textures) and test_spot
     (LocalShadow) frames, 4 warm-up + 16 timed + 1 frames each: finite
     LDR, non-empty coverage, real motion vectors, a TAAHistory that
     changes between frames, and the raster kernel's launches (camera
     every frame, sun once, one per shadow-casting spot per frame); prints
     ms/frame, the per-pass table and peak memory of each.
The line before the last is the kernels' JSON, one entry per raster (camera,
sun, local shadow) of the one kernel; the last line is
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


def check_golden(name: str, img: torch.Tensor) -> None:
    """Hold a 256x256 LDR image rendered on the card against
    tests/goldens/<name>.png under the golden test's thresholds."""
    from arkoserenderer_torch.utils.imageio import load_png, to_u8

    golden = load_png(str(ROOT / "tests" / "goldens" / f"{name}.png"))[..., :3]
    diff = np.abs(to_u8(img.cpu().numpy()).astype(int) - golden.astype(int))
    if not (diff.mean() < 1.5 and (diff > 24).mean() < 0.005):
        raise AssertionError(f"golden {name}: mean abs diff {diff.mean():.4f}, "
                             f"{(diff > 24).mean():.4%} pixels off by > 24")
    print(f"golden {name} 256x256 on the card: mean abs diff {diff.mean():.4f} (< 1.5), "
          f"{(diff > 24).mean():.4%} pixels off by > 24 (< 0.5%)", flush=True)


def print_frame_table(result: dict, card: str) -> None:
    print(f"frame ms: {[round(x, 4) for x in result['frame_ms']]}")
    print(f"per-pass median ms [{card}]:")
    for name, ms in result["pass_ms"].items():
        print(f"  {name:20s} {ms:10.4f}")
    print(f"  {'sum of passes':20s} {sum(result['pass_ms'].values()):10.4f}", flush=True)


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
    from arkoserenderer_torch.tools import bench
    from arkoserenderer_torch.tools import raster_bench as rb

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

    def compare_and_time(name, label, p_iters, setup, bins, w, h, depth_only):
        err = compare(label, setup, bins, w, h, full_raster, depth_only)[0]
        device_ms = rb.kernel_ms(lib, setup, bins, w, h, full_raster, depth_only)
        k_ms = rb.events_ms(lambda: rasterize_tiles_cuda(setup, bins, w, h, full_raster,
                                                         depth_only=depth_only),
                            rb.WRAPPER_CALLS[name])
        p_ms = rb.events_ms(lambda: raster.rasterize_tiles_plain(setup, bins, w, h, full_raster,
                                                                 depth_only=depth_only), p_iters)
        before, after = rb.pixel_tests(setup, bins, w, h, full_raster)
        bound, kind = rb.bound_ms(setup, bins, w, h, depth_only, after)
        timed[name] = dict(max_abs_err=err, ms=k_ms, device_ms=device_ms, plain_ms=p_ms,
                           bound_ms=bound, bound_by=kind, shape=label)
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

    for name, label, p_iters in (("camera", f"camera {W}x{H}, tile 8x128", 5),
                                 ("sun", f"sun {S}x{S} depth-only", 2)):
        compare_and_time(name, label, p_iters, *cases[name])
    timed["camera"]["max_abs_err"] = max(errs + [timed["camera"]["max_abs_err"]])
    del cases, setup, bins

    # -- 4. golden on the card ----------------------------------------------------
    g_cfg = PipelineConfig(width=256, height=256,
                           raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                           shadow_map_size=256)
    g_scene, g_cam = build_test_scene(viewport=(256, 256))
    check_golden("forward", Renderer(g_scene, g_cam, g_cfg, device=dev, taa=False,
                                     bloom=False).render_frame())

    # -- 5. the slice at full size --------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rasterize_tiles_cuda.launches = 0
    rasterize_tiles_cuda.launches_by_shape.clear()
    slice1 = r.benchmark(warmup=WARMUP, iters=FRAMES - WARMUP)
    launches = rasterize_tiles_cuda.launches
    slice1_launches = dict(rasterize_tiles_cuda.launches_by_shape)
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
    print(f"forward slice {W}x{H} shadow {S}: {FRAMES} frames, median "
          f"{slice1['ms_per_frame']:.4f} "
          f"ms/frame over the last {FRAMES - WARMUP} (CUDA events), coverage {coverage:.4f}, "
          f"raster launches {launches}, peak memory {peak / 2**30:.3f} GiB [{card}]", flush=True)
    print_frame_table(slice1, card)
    del r

    # -- 6. the full_post golden on the card ----------------------------------------
    g_scene, g_cam = build_test_scene(viewport=(256, 256))
    check_golden("full_post", Renderer(g_scene, g_cam, g_cfg, device=dev, ssao=True,
                                       motion_blur=True).render_frames(3))

    # -- 7. the local-shadow raster --------------------------------------------------
    spot = bench.build_renderer("test_spot", device=dev)
    A = spot.cfg.local_shadow_map_size
    compare_and_time("local", f"local shadow {A}x{A} depth-only", 5,
                     *rb.local_shadow_raster_inputs(spot.scene_arrays, spot.camera.state(0, dev),
                                                    A, full_raster))
    del spot

    # -- 8. the frames of this slice, through the bench -------------------------------
    shapes = {"camera": (H, W, False), "sun": (S, S, True), "local": (A, A, True)}
    slice3_launches = dict.fromkeys(shapes.values(), 0)
    for name in bench.CONFIGS:
        rasterize_tiles_cuda.launches_by_shape.clear()
        res, renderer = bench.run_config(name, warmup=WARMUP, iters=FRAMES - WARMUP)
        by_shape = dict(rasterize_tiles_cuda.launches_by_shape)
        n = res["frames"]
        casters = sum(renderer.cfg.scene.spot_shadow_casters)
        want = {shapes["camera"]: n, shapes["sun"]: 1}
        if casters:
            want[shapes["local"]] = casters * n
        if by_shape != want or res["raster_launches"] != res["raster_launches_expected"]:
            raise AssertionError(f"{name}: raster launches {by_shape} in {n} frames, "
                                 f"expected {want}")
        if (res["width"], res["height"], res["shadow_map_size"]) != (W, H, S):
            raise AssertionError(f"{name}: not the full-size configuration")
        if tuple(renderer.state["LDR"].shape) != (H, W, 3) or not res["ldr_finite"]:
            raise AssertionError(f"{name}: LDR is not a finite (H, W, 3) image")
        if res["coverage"] <= 0.0:
            raise AssertionError(f"{name}: the frame covers no pixel")
        if res["max_velocity_px"] <= 1.0:
            raise AssertionError(f"{name}: the moving camera gave no motion vectors")
        if res["taa_history_delta"] <= 1e-4:
            raise AssertionError(f"{name}: TAAHistory did not change between frames")
        for shape, count in by_shape.items():
            slice3_launches[shape] += count
        print(f"{name} {W}x{H} shadow {S}: {n} frames, median {res['ms_per_frame']:.4f} ms/frame "
              f"over {FRAMES - WARMUP} (CUDA events; min {res['ms_min']:.4f}, max "
              f"{res['ms_max']:.4f}; host wall clock {res['wall_ms_per_frame']:.4f}), coverage "
              f"{res['coverage']:.4f}, max velocity {res['max_velocity_px']:.2f} px, TAAHistory "
              f"moved {res['taa_history_delta']:.4f}, raster launches {by_shape}, peak memory "
              f"{res['peak_memory_gib']:.3f} GiB [{card}]", flush=True)
        print_frame_table(res, card)
        print(json.dumps(res), flush=True)
        del renderer
    if not all(slice3_launches.values()):
        raise AssertionError(f"a raster of this slice's path was never launched: "
                             f"{slice3_launches}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": slice3_launches[shapes[name]],
        "launches_forward_slice": slice1_launches.get(shapes[name], 0),
        **timed[name], "library_ms": None,
    } for name in ("camera", "sun", "local")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
