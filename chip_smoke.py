#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (arkoserenderer_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a
result line):
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off;
  2. build: compiles the hand-written kernels from csrc/ with nvcc (one
     process per source, in parallel) and prints ptxas's registers, shared
     memory and spills (none allowed);
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
     (LocalShadow) frames, 4 warm-up + 16 timed + 4 counted frames each:
     finite LDR, non-empty coverage, real motion vectors, a TAAHistory that
     changes between frames, and the raster kernel's launches by shape as
     the configuration implies them (bench.expected_launches_by_shape:
     camera every frame, sun once under the static cache, one per
     shadow-casting spot per frame); prints ms/frame, the per-pass table and
     peak memory of each;
  9. the same for the stress (4,096 animated cells with LOD chains, 983,042
     pool triangles; the sun rastered every frame; a still camera, so the
     motion vectors are the animation's) and meshlet (+ per-meshlet
     culling) frames and forward_upscaled (1280x720 with TemporalUpscale to
     1920x1080: LDRDisplay and UpscaleHistory), with the triangles left
     after culling, the meshlets kept and the camera's and sun's dropped
     bin entries of the counted frames; then the kernel against its plain
     version bit for bit on one animated stress frame's camera and sun
     rasters and on the 1280x720 camera, timed like phase 3; and the stress
     grid at 128^2 animated in the frame against the host's
     dynamic_transforms path (mean abs diff < 1e-3, under 0.5 % of pixels
     off by more than 0.05: the thresholds of tests/test_stress.py).
 10. the rt frame (the test_spot scene and spot with rt_shadows and
     rt_reflections) and the BVH traversal kernel: the five traces of one
     1920x1080 frame (sun mask, spot mask 0, reflection rays, and the sun
     and spot 0 occlusion rays at the reflection hits; parked and compacted rays
     included) captured as the frame makes them, 262,144 DDGI-shaped probe
     rays through the rt scene (1,024 probes x 256 directions), and random
     rays through a 4,096-instance TLAS (closest-hit, and any-hit with
     per-ray t_max), each through the kernel and its plain torch version:
     t, tri, u, v and hit equal bit for bit; the kernel's wrapper, device and
     plain times and its bound from the plain walk's counts
     (tools/trace_bench.py), and its resident warps a SM; the edge rays
     (ray counts 0, 1, 33 and 4,099, zero and -0.0 direction components,
     -0.0 origins, t_max inf and 0, origins inside instance boxes) and the
     chain that overflows the stack, cut at 9, 20 and 512 steps, each bit
     for bit against the plain walk; the 256^2 rt golden
     (tests/goldens/rt.png) rendered on the card; then the rt frame through
     the bench as in phase 8, with one camera raster and no other a frame,
     and the traversal launches by trace as the configuration implies them
     (bench.expected_trace_launches_by_label): exactly five a frame.
 11. DDGI: the 256^2 ddgi and showcase goldens (tests/goldens/ddgi.png,
     showcase.png) rendered on the card; then the showcase (8x4x8 grid:
     8,192 probe rays a frame) and flagship (4,096 spheres, 786,434
     triangles, a 16x8x16 grid: 262,144 probe rays a frame) frames through
     the bench as in phase 8, each of the 4 counted frames finite, covered
     and moving every DDGI atlas, with the raster launches by shape (the
     camera only: RT shadows) and the traversal launches by trace as
     implied (five and eleven a frame); after each run's counts are read,
     every trace of one more frame of that renderer (the showcase's five;
     the flagship's eleven: sun mask, spot masks 0 and 1, reflection, sun
     occlusion, spot occlusions 0 and 1, ddgi probe, ddgi sun, ddgi spots
     0 and 1), captured as the frame makes them, through the kernel and its
     plain version bit for bit and timed as in phase 10, and the flagship
     camera raster bit for bit and timed as in phase 3.
 12. the ddgi frame (the test scene with a skinned box and a morphed
     sphere, DDGI on a 16x8x16 grid at 256 rays x 1,024 probes a frame, and
     SSSS): through the bench as in phase 11, BVHRefit after Geometry and
     SSSS after LightingCompose, each counted frame finite, covered and
     moving every DDGI atlas, the raster launches by shape (camera and the
     8192^2 sun every frame: animated geometry is not cacheable) and the
     traversal launches by trace (ddgi probe and ddgi sun, two a frame);
     then one more frame, whose two DDGI traces (262,144 rays each, through
     the BVH refitted in that frame) go through the kernel and its plain
     version bit for bit and whose camera and sun rasters (from the skinned
     and morphed pool) are held bit for bit against the plain raster, all
     captured as the frame makes them and timed as in phases 3 and 10.
 13. the helmet (glTF import): the port's JPEG decoder (csrc/jpeg_decode.c,
     host C built here with the host compiler) on the DamagedHelmet's five
     2048^2 textures, each equal to the SHA-256 of PIL's pixels recorded on
     a machine with PIL; the 256^2 helmet golden (tests/goldens/helmet.png)
     rendered on the card; then the helmet frame (36 DamagedHelmets, 556,274
     triangles, 1024^2 textures, RT sun shadows, DDGI at 256 rays x 1,024
     probes of a 16x4x16 grid) through the bench as in phase 11, with the
     host's build time by stage, each counted frame finite, covered and
     moving every DDGI atlas, the camera raster only and three traces a
     frame (sun mask, ddgi probe, ddgi sun), the camera's dropped bin
     entries; then one more frame's camera raster and three traces,
     captured as the frame makes them, bit for bit against their plain
     versions and timed as in phases 3 and 10.
 14. ground truth: the 256^2 pathtraced golden (tests/goldens/pathtraced.png:
     PathTracer, two bounces, 4 samples) rendered on the card; the
     pathtraced kind through the bench (the test scene at 1920x1080, three
     bounces, AgX, AA: 4 warm-up + 16 timed samples; finite radiance and
     LDR; the traversal launches by trace as implied, seven a sample: "pt
     ray 0-3", "pt sun 0-2"), then every trace of one more sample, captured
     as the sample makes it, bit for bit against the plain walk and timed
     as in phase 10; the truth check at 1920x1080: the flat scene's
     forward frame (sun only, RT shadows, no vignette) against one
     PathTracer(aa=False, max_bounces=1) sample under tests/test_truth.py's
     thresholds (smooth pixels > 70 %, mean rel < 0.01, < 1.5 % of them off
     by > 5 %); and bake_vertex_ao over the helmet scene of phase 13 (64
     rays a hemisphere: 128 traces), timed, AO in [0, 1], a 4,096-vertex
     subset equal to the plain walk's AO and bent normals, and its first
     trace captured and measured.
 15. the rt_soft frame (the rt frame with a 10 degree sun and a 0.35 m
     spot: blue-noise disk samples through the shadow denoiser) through the
     bench as phase 10 runs rt: five traces a frame, the camera raster only,
     a penumbra (pixels with 0.15 < mask < 0.85) in ShadowMask.sun and in
     the spot's plane, then every trace of one more frame bit for bit
     against the plain walk and timed.
The line before the last is the kernels' JSON: one entry per raster the
raster kernel serves (1080p camera, cached sun, local shadow, stress
camera, per-frame stress sun, 720p camera, flagship camera, ddgi camera,
per-frame ddgi sun, helmet camera), each with its launches in the runs of
the frame kinds that launch it, and one entry per trace the traversal
kernel serves in the rt, showcase, flagship, ddgi, helmet and rt_soft
frames, the pathtraced sample and the AO bake, each with its launches by
its label in that kind's run; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FRAMES, WARMUP = 20, 4
PHASE8 = ("forward", "full_post", "bindless", "test_spot")
PHASE9 = ("stress", "meshlet", "forward_upscaled")
TPU_KERNEL = "arkoserenderer_tpu/ops/raster_pallas.py:63"
KERNEL_SOURCE = "arkoserenderer_torch/csrc/raster_tiles.cu"
# The traversal kernel replaces the reference's XLA while-loop (not a Pallas
# kernel) of the 8-wide walk.
TRACE_REPLACES = "arkoserenderer_tpu/ops/bvh.py:1001"
TRACE_SOURCE = "arkoserenderer_torch/csrc/bvh_trace.cu"
RT_TRACES = ("sun mask", "spot mask 0", "reflection", "sun occlusion", "spot occlusion 0")
# Frame kind -> (traces a frame, DDGI rays a trace: probes a frame x rays a probe).
PHASE11 = {"showcase": (5, 64 * 128), "flagship": (11, 1024 * 256)}
# SHA-256 of PIL's Image.open(...).convert("RGBA") pixels of each helmet
# texture (Pillow 12.1.0 with libjpeg-turbo), which the port's decoder,
# built where the script runs, must give too.
HELMET_TEXTURES = {
    "Default_albedo.jpg": "57eeab31e3b820cce2e296942937868102d38ef4905d7130e8bddf2fa7ed692a",
    "Default_normal.jpg": "8720e7d1cd61e6b5ddac62f07a70e8cd7e9ef8a32d9b4b8dbaa6759c8ed7f338",
    "Default_metalRoughness.jpg":
        "b4120c6874a5b28cd7a00dc7fe8a6001b98abcdacddf52e5a58c7d480d3e0497",
    "Default_emissive.jpg": "318c6044e80796641ce63514f23bb1ce8e49e1ca8fbb960e2e60286e724cdb2d",
    "Default_AO.jpg": "1fb7529f9a51067f96dc1a1d296019530cba344953551db0c4b035c0e680fb7a",
}


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


def truth_metrics(raster: np.ndarray, pt: np.ndarray):
    """tests/test_truth.py's per-pixel metric: (mask of the smooth pixels,
    where no 3x3 neighbour crosses a luminance step of 0.03; relative
    error of the path-traced pixel against the raster's)."""
    lum = raster.mean(-1)
    gx = np.abs(np.diff(lum, axis=1, prepend=lum[:, :1]))
    gy = np.abs(np.diff(lum, axis=0, prepend=lum[:1]))
    g = (gx + gy) > 0.03
    edge = g.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= np.roll(np.roll(g, dy, 0), dx, 1)
    return ~edge, np.abs(pt - raster).max(-1) / (raster.mean(-1) + 0.02)


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
    sources = ", ".join(p.name for p in sorted((ROOT / "arkoserenderer_torch" / "csrc").glob("*.cu")))
    print(f"build: {sources} built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
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
              f"max tri/tile {int(bins.counts.max())}, global {int(bins.global_count)}, "
              f"overflow {int(bins.overflow)}", flush=True)
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

    # -- 8. and 9. the frame kinds, through the bench ---------------------------------
    def run_kind(name):
        """One frame kind through the bench: the launch counts are zeroed
        just before it and read just after; every check of its frames."""
        rasterize_tiles_cuda.launches_by_shape.clear()
        res, renderer = bench.run_config(name, warmup=WARMUP, iters=FRAMES - WARMUP)
        by_shape = dict(rasterize_tiles_cuda.launches_by_shape)
        n = res["frames"]
        want = bench.expected_launches_by_shape(renderer, n)
        if by_shape != want or res["raster_launches"] != res["raster_launches_expected"]:
            raise AssertionError(f"{name}: raster launches {by_shape} in {n} frames, "
                                 f"expected {want}")
        if (res["shadow_map_size"], tuple(res["display"])) != (S, (H, W)):
            raise AssertionError(f"{name}: not the full-size configuration")
        out = renderer.state.get("LDRDisplay", renderer.state["LDR"])
        if tuple(out.shape) != (H, W, 3) or not res["ldr_finite"]:
            raise AssertionError(f"{name}: the display image is not a finite (H, W, 3) image")
        if res["coverage"] <= 0.0:
            raise AssertionError(f"{name}: the frame covers no pixel")
        if res["max_velocity_px"] <= MIN_VELOCITY_PX[name]:
            raise AssertionError(f"{name}: motion vectors of at most {res['max_velocity_px']} px")
        if res["history_delta"] <= 1e-4:
            raise AssertionError(f"{name}: {res['history']} did not change between frames")
        print(f"{name} {res['width']}x{res['height']} -> {W}x{H} shadow {S}: {n} frames, median "
              f"{res['ms_per_frame']:.4f} ms/frame over {FRAMES - WARMUP} (CUDA events; min "
              f"{res['ms_min']:.4f}, max {res['ms_max']:.4f}; host wall clock "
              f"{res['wall_ms_per_frame']:.4f}), coverage {res['coverage']:.4f}, max velocity "
              f"{res['max_velocity_px']:.2f} px, {res['history']} moved "
              f"{res['history_delta']:.4f}, raster launches {by_shape}, peak memory "
              f"{res['peak_memory_gib']:.3f} GiB [{card}]", flush=True)
        for i, c in enumerate(res["frame_counts"]):
            print(f"  frame {n - len(res['frame_counts']) + i}: {c}")
        print_frame_table(res, card)
        print(json.dumps(res), flush=True)
        return res, renderer, by_shape

    # The camera moves 3 cm a frame in phase 8 and upscaled frames; in the
    # stress frames it stands still, so the motion vectors are the grid's.
    MIN_VELOCITY_PX = {"forward": 1.0, "full_post": 1.0, "bindless": 1.0, "test_spot": 1.0,
                       "forward_upscaled": 1.0, "stress": 0.5, "meshlet": 0.5, "rt": 1.0,
                       "showcase": 1.0, "flagship": 1.0, "ddgi": 1.0, "helmet": 1.0,
                       "rt_soft": 1.0}
    by_kind = {}
    for name in PHASE8:
        by_kind[name] = run_kind(name)[2]

    # -- 9. the stress, meshlet and forward_upscaled frames ---------------------------
    for name in PHASE9:
        res, renderer, by_kind[name] = run_kind(name)
        if name == "stress":
            # One animated frame's camera and sun rasters, bit for bit.
            sa = renderer.pipeline.scene_animator(renderer.scene_arrays, renderer.frame_index,
                                                  1 / 60)
            cases = rb.forward_raster_inputs(sa, renderer.camera.state(renderer.frame_index, dev),
                                             renderer.cfg.scene, W, H, S, full_raster)
            compare_and_time("camera_stress", f"stress camera {W}x{H}, tile 8x128", 2,
                             *cases["camera"])
            compare_and_time("sun_stress", f"stress sun {S}x{S} depth-only (every frame)", 1,
                             *cases["sun"])
            del cases, sa
        if name == "forward_upscaled":
            rw, rh = res["width"], res["height"]
            cases = rb.forward_raster_inputs(
                renderer.scene_arrays, renderer.camera.state(renderer.frame_index, dev),
                renderer.cfg.scene, rw, rh, S, full_raster)
            compare_and_time("camera_720p", f"camera {rw}x{rh}, tile 8x128", 5,
                             *cases["camera"])
            del cases
        del renderer
    img_d, img_h = bench.animation_paths(dev)
    diff = (img_d - img_h).abs()
    flips = (diff.amax(dim=-1) > 0.05).float().mean().item()
    if not (bool(torch.isfinite(img_d).all()) and diff.mean().item() < 1e-3 and flips < 0.005):
        raise AssertionError(f"stress animator vs host transforms: mean abs diff "
                             f"{diff.mean().item()}, {flips:.4%} pixels off by > 0.05")
    print(f"stress 128x128 on the card, animator vs host dynamic_transforms: mean abs diff "
          f"{diff.mean().item():.6f} (< 1e-3), {flips:.4%} pixels off by > 0.05 (< 0.5%)",
          flush=True)

    # -- 10. the rt frame and the traversal kernel ------------------------------------
    from arkoserenderer_torch.scene.lights import SpotLight
    from arkoserenderer_torch.tools import trace_bench as tb

    rt_renderer = bench.build_renderer("rt", device=dev)
    traces = tb.frame_cases(rt_renderer)
    if tuple(t["name"] for t in traces) != RT_TRACES:
        raise AssertionError(f"the rt frame traced {[t['name'] for t in traces]}, "
                             f"expected {list(RT_TRACES)}")
    for t in traces + tb.probe_cases(rt_renderer) + tb.tlas_cases(dev):
        print(tb.describe(t, card), flush=True)
    del rt_renderer
    print(tb.occupancy_line(lib), flush=True)
    for line in tb.edge_checks(dev):
        print(line, flush=True)
    g_scene, g_cam = build_test_scene(viewport=(256, 256), n_spheres=1)
    g_scene.spots.append(SpotLight(position=np.array([0.5, 3.0, 1.0], np.float32),
                                   direction=np.array([-0.2, -1.0, -0.1], np.float32),
                                   luminous_intensity_cd=150000.0, cast_shadows=True))
    check_golden("rt", Renderer(g_scene, g_cam, g_cfg, device=dev, rt_shadows=True,
                                rt_reflections=True, taa=False, bloom=False).render_frames(2))
    res, renderer, by_kind["rt"] = run_kind("rt")
    n = res["frames"]
    if (res["trace_launches"] != res["trace_launches_expected"]
            or sum(res["trace_launches"].values()) != 5 * n):
        raise AssertionError(f"rt: traversal launches {res['trace_launches']} in {n} frames, "
                             f"expected {res['trace_launches_expected']} (5 a frame)")
    print(f"rt: traversal launches {res['trace_launches']} in {n} frames (5 a frame)",
          flush=True)
    trace_launches = res["trace_launches"]
    del renderer

    # -- 11. DDGI: goldens, the flagship's DDGI traces and camera, the frames --------
    from arkoserenderer_torch.ops.ddgi import ProbeGridConfig

    for name, kw in (("ddgi", dict(taa=False, bloom=False)),
                     ("showcase", dict(rt_shadows=True, rt_reflections=True, ssao=True, fog=True,
                                       motion_blur=True))):
        g_scene, g_cam = build_test_scene(viewport=(256, 256), n_spheres=1)
        check_golden(name, Renderer(g_scene, g_cam, g_cfg, device=dev, ddgi=ProbeGridConfig(),
                                    **kw).render_frames(2))
    def run_traced_kind(name, per_frame):
        """run_kind, then the traversal launches by trace (``per_frame`` a
        frame) and every counted frame finite, covered and moving the DDGI
        atlases."""
        res, renderer, by_kind[name] = run_kind(name)
        n = res["frames"]
        if (res["trace_launches"] != res["trace_launches_expected"]
                or sum(res["trace_launches"].values()) != per_frame * n):
            raise AssertionError(f"{name}: traversal launches {res['trace_launches']} in {n} "
                                 f"frames, expected {res['trace_launches_expected']} "
                                 f"({per_frame} a frame)")
        for i, c in enumerate(res["frame_checks"]):
            moved = [c[f"{k}_delta"] for k in ("DDGI.irradiance", "DDGI.visibility")]
            if not (c["ldr_finite"] and c["coverage"] > 0.0 and min(moved) > 0.0):
                raise AssertionError(f"{name}: counted frame {i} failed its checks: {c}")
        print(f"{name}: traversal launches {res['trace_launches']} in {n} frames ({per_frame} a "
              f"frame); counted frames {res['frame_checks']}", flush=True)
        return res, renderer

    def check_kind_traces(name, res, cases, ddgi_rays):
        """One frame's captured traces: one of each the run counted, DDGI's
        of ``ddgi_rays`` rays; each measured bit for bit against the plain
        walk on the BVH it walked."""
        got = sorted((c["trace"], c["origins"].shape[0]) for c in cases)
        if [t for t, _ in got] != sorted(res["trace_launches_expected"]) or any(
                r != ddgi_rays for t, r in got if t.startswith("ddgi")):
            raise AssertionError(f"a {name} frame traced {got}, expected one trace of each of "
                                 f"{sorted(res['trace_launches_expected'])}, DDGI's of "
                                 f"{ddgi_rays} rays")
        measured = [tb.measure(c["bvh"], c) for c in cases]
        for t in measured:
            print(tb.describe(t, card), flush=True)
        return [(res["trace_launches"], t) for t in measured]

    kind_traces = []  # (the kind's run's launches by label, measured trace)
    for name, (per_frame, ddgi_rays) in PHASE11.items():
        res, renderer = run_traced_kind(name, per_frame)
        # The counts are read: every trace of one more frame, bit for bit.
        cases = tb.kind_traces(renderer, name)
        kind_traces += check_kind_traces(name, res, cases, ddgi_rays)
        if name == "flagship":
            cam = rb.forward_raster_inputs(renderer.scene_arrays,
                                           renderer.camera.state(renderer.frame_index, dev),
                                           renderer.cfg.scene, W, H, S, full_raster)
            compare_and_time("camera_flagship", f"flagship camera {W}x{H}, tile 8x128", 2,
                             *cam["camera"])
            del cam
        del renderer, cases

    # -- 12. the ddgi frame: skinning, morphs, the per-frame refit, SSSS ---------------
    res, renderer = run_traced_kind("ddgi", 2)
    if res["passes"][:4] != ["Scene", "Geometry", "BVHRefit", "DDGI"] or not (
            "SSSS" in res["pass_ms"] and "BVHRefit" in res["pass_ms"]):
        raise AssertionError(f"ddgi: passes {res['passes']}, timed {list(res['pass_ms'])}")
    # The counts are read: one more frame's rasters and traces, as it makes them.
    rasters, cases = rb.capture_rasters(lambda: tb.kind_traces(renderer, "ddgi"))
    if sorted(rasters) != sorted(bench.expected_launches_by_shape(renderer, 1)):
        raise AssertionError(f"a ddgi frame rastered {sorted(rasters)}")
    if any(c["bvh"] is renderer.scene_arrays.bvh for c in cases):
        raise AssertionError("a ddgi trace walked the build-time BVH, not the frame's refit")
    kind_traces += check_kind_traces("ddgi", res, cases, 1024 * 256)
    compare_and_time("camera_ddgi", f"ddgi camera {W}x{H}, tile 8x128 (skinned and morphed "
                     "pool)", 2, *rasters[H, W, False])
    compare_and_time("sun_ddgi", f"ddgi sun {S}x{S} depth-only (every frame)", 1,
                     *rasters[S, S, True])
    del renderer, cases, rasters

    # -- 13. the helmet: the decoder, the golden, the frame and its kernels -----------
    from arkoserenderer_torch.assets import imagecodec
    from arkoserenderer_torch.assets.sample_scenes import build_helmet_golden_scene

    t0 = time.perf_counter()
    imagecodec.build_decoder()
    print(f"decoder: {imagecodec.SOURCE.name} built with {imagecodec.host_compiler()} and "
          f"loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, want in HELMET_TEXTURES.items():
        data = (ROOT / "assets" / "sample" / "DamagedHelmet" / name).read_bytes()
        t0 = time.perf_counter()
        px = imagecodec.decode_image(data)
        ms = (time.perf_counter() - t0) * 1e3
        got = hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()
        if got != want:
            raise AssertionError(f"decoder: {name} pixels hash {got}, PIL's {want}")
        print(f"decoder: {name} {px.shape} equals PIL's pixels (SHA-256 {got[:16]}...), "
              f"{ms:.1f} ms on the host", flush=True)
    g_scene, g_cam = build_helmet_golden_scene()
    check_golden("helmet", Renderer(g_scene, g_cam, g_cfg, device=dev, taa=False,
                                    bloom=False).render_frame())
    textures = bench.texture_times()
    res, renderer = run_traced_kind("helmet", 3)
    print(bench.build_line("helmet", res, textures), flush=True)
    rasters, cases = rb.capture_rasters(lambda: tb.kind_traces(renderer, "helmet"))
    if not (sorted(rasters) == sorted(bench.expected_launches_by_shape(renderer, 1))
            == [(H, W, False)]):
        raise AssertionError(f"a helmet frame rastered {sorted(rasters)}")
    kind_traces += check_kind_traces("helmet", res, cases, 1024 * 256)
    compare_and_time("camera_helmet", f"helmet camera {W}x{H}, tile 8x128 (556,274 triangles)",
                     2, *rasters[H, W, False])
    helmet_arrays = renderer.scene_arrays  # phase 14 bakes its AO
    del renderer, cases, rasters

    # -- 14. ground truth: the path tracer, the truth check, AO baking ----------------
    from arkoserenderer_torch.assets.procedural import build_flat_test_scene
    from arkoserenderer_torch.models.pathtracer import PathTracer, world_space_vertices
    from arkoserenderer_torch.ops.bake_ao import bake_ao, bake_vertex_ao, world_normals

    g_scene, g_cam = build_test_scene(viewport=(256, 256), n_spheres=1)
    g_tracer = PathTracer(g_scene, g_cam, 256, 256, max_bounces=2, seed=7, device=dev)
    g_tracer.render_sample(4)
    check_golden("pathtraced", g_tracer.ldr())
    del g_tracer
    res, tracer = bench.run_pathtraced(warmup=WARMUP, iters=FRAMES - WARMUP)
    n = res["samples"]
    pt_launches = res["trace_launches"]
    if (pt_launches != res["trace_launches_expected"] or sum(pt_launches.values()) != 7 * n
            or (res["width"], res["height"]) != (W, H)):
        raise AssertionError(f"pathtraced: traversal launches {pt_launches} in {n} samples, "
                             f"expected {res['trace_launches_expected']} (7 a sample)")
    if not (res["radiance_finite"] and res["ldr_finite"] and res["mean_ldr"] > 0.0):
        raise AssertionError(f"pathtraced: radiance or LDR not finite, or black: {res}")
    print(bench.build_line("pathtraced", res), flush=True)
    print(f"pathtraced {W}x{H}, {res['max_bounces']} bounces: {n} samples, median "
          f"{res['ms_per_sample']:.4f} ms/sample over {FRAMES - WARMUP} (CUDA events; min "
          f"{res['ms_min']:.4f}, max {res['ms_max']:.4f}; host wall clock "
          f"{res['wall_ms_per_sample']:.4f}), {res['rays_per_sample']} rays a sample, "
          f"{res['rays_per_s'] / 1e9:.4f} Grays/s, traversal launches {pt_launches}, mean LDR "
          f"{res['mean_ldr']:.4f}, peak memory {res['peak_memory_gib']:.3f} GiB [{card}]",
          flush=True)
    print(json.dumps(res), flush=True)
    cases = tb.capture_calls(lambda: tracer.render_sample(1))
    for c in cases:
        c["trace"] = c["label"]
        c["label"] = f"pathtraced {c['label']}"
    if sorted(c["trace"] for c in cases) != sorted(res["trace_launches_expected"]):
        raise AssertionError(f"a pathtraced sample traced {[c['trace'] for c in cases]}")
    measured = [tb.measure(c["bvh"], c) for c in cases]
    for t in measured:
        print(tb.describe(t, card), flush=True)
    kind_traces += [(pt_launches, t) for t in measured]
    del tracer, cases

    t_scene, t_cam = build_flat_test_scene(viewport=(W, H))
    truth_raster = Renderer(t_scene, t_cam, full_cfg, device=dev, rt_shadows=True, taa=False,
                            bloom=False, vignette=0.0).render_frame().cpu().numpy()
    t_scene, t_cam = build_flat_test_scene(viewport=(W, H))
    truth_tracer = PathTracer(t_scene, t_cam, W, H, max_bounces=1, seed=3, aa=False, device=dev)
    truth_tracer.render_sample(1)
    truth_pt = truth_tracer.ldr().cpu().numpy()
    del truth_tracer
    mask, rel = truth_metrics(truth_raster, truth_pt)
    mean_rel, frac_bad = rel[mask].mean(), (rel[mask] > 0.05).mean()
    if not (np.isfinite(truth_pt).all() and mask.mean() > 0.7 and mean_rel < 0.01
            and frac_bad < 0.015):
        raise AssertionError(f"truth check {W}x{H}: smooth {mask.mean():.4f}, mean rel "
                             f"{mean_rel:.6f}, {frac_bad:.4%} of smooth pixels off by > 5%")
    print(f"truth check {W}x{H} on the card (flat scene, sun only, RT shadows): raster vs one "
          f"path-traced sample, smooth pixels {mask.mean():.4f} (> 0.7), mean rel "
          f"{mean_rel:.6f} (< 0.01), {frac_bad:.4%} of smooth pixels off by > 5% (< 1.5%)",
          flush=True)

    trace_rays_cuda = tb.bvh_cuda.trace_rays_cuda
    trace_rays_cuda.launches_by_label.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ao, bent = bake_vertex_ao(helmet_arrays)
    ao_ms = (time.perf_counter() - t0) * 1e3
    ao_launches = dict(trace_rays_cuda.launches_by_label)
    n_used = int(helmet_arrays.indices.max()) + 1
    if ao_launches != {"ao": 128} or not (np.isfinite(ao).all() and (ao >= 0).all()
                                          and (ao <= 1).all() and np.isfinite(bent).all()):
        raise AssertionError(f"bake_vertex_ao: launches {ao_launches}, AO in "
                             f"[{ao.min()}, {ao.max()}]")
    idx = torch.linspace(0, n_used - 1, 4096, device=dev).long()
    wp = torch.from_numpy(world_space_vertices(helmet_arrays).astype(np.float32)).to(dev)
    nrm = world_normals(helmet_arrays)
    with tb.plain_traces():
        ao_p, bent_p = bake_ao(helmet_arrays.bvh, wp[idx], nrm[idx])
    sub = idx.cpu().numpy()
    if not (np.array_equal(ao[sub], ao_p.cpu().numpy())
            and np.array_equal(bent[sub], bent_p.cpu().numpy())):
        raise AssertionError("bake_vertex_ao: the kernel's AO differs from the plain walk's")
    print(f"bake_vertex_ao helmet scene: {ao.shape[0]} pool vertices ({n_used} used), 128 "
          f"traces, {ao_ms:.2f} ms on the host's clock, AO in [{ao[:n_used].min():.4f}, "
          f"{ao[:n_used].max():.4f}] (mean {ao[:n_used].mean():.4f}), 4,096-vertex subset "
          f"equal to the plain walk's AO and bent normals bit for bit [{card}]", flush=True)
    ao_case = tb.capture_calls(lambda: bake_ao(helmet_arrays.bvh, wp[:n_used], nrm[:n_used],
                                               num_rays=1))[0]
    ao_case.update(trace="ao", label="helmet ao (first direction)")
    measured = tb.measure(ao_case["bvh"], ao_case)
    print(tb.describe(measured, card), flush=True)
    kind_traces.append((ao_launches, measured))
    del helmet_arrays, wp, nrm, ao_case

    # -- 15. soft RT shadows: the rt_soft frame -----------------------------------------
    res, renderer, by_kind["rt_soft"] = run_kind("rt_soft")
    n = res["frames"]
    if (res["trace_launches"] != res["trace_launches_expected"]
            or sum(res["trace_launches"].values()) != 5 * n):
        raise AssertionError(f"rt_soft: traversal launches {res['trace_launches']} in {n} "
                             f"frames, expected {res['trace_launches_expected']} (5 a frame)")
    sun_mask = renderer.state["ShadowMask.sun"]
    spot_mask = renderer.state["ShadowMask.locals"][0]
    penumbra = [int(((m > 0.15) & (m < 0.85)).sum()) for m in (sun_mask, spot_mask)]
    if min(penumbra) < 100 or not {"RTShadow.history", "RTLocalShadow.history"} <= set(
            renderer.state):
        raise AssertionError(f"rt_soft: penumbra pixels (sun, spot) {penumbra}")
    print(f"rt_soft: traversal launches {res['trace_launches']} in {n} frames (5 a frame); "
          f"penumbra pixels (0.15 < mask < 0.85): sun {penumbra[0]}, spot {penumbra[1]}",
          flush=True)
    kind_traces += check_kind_traces("rt_soft", res, tb.kind_traces(renderer, "rt_soft"), 0)
    del renderer

    # Each raster of the kernels line: the kinds whose runs launch it, and its shape.
    entries = {
        "camera": (PHASE8 + ("rt", "showcase", "rt_soft"), (H, W, False)),
        "sun": (PHASE8 + ("forward_upscaled",), (S, S, True)),
        "local": (PHASE8, (A, A, True)),
        "camera_stress": (("stress", "meshlet"), (H, W, False)),
        "sun_stress": (("stress", "meshlet"), (S, S, True)),
        "camera_720p": (("forward_upscaled",), (720, 1280, False)),
        "camera_flagship": (("flagship",), (H, W, False)),
        "camera_ddgi": (("ddgi",), (H, W, False)),
        "sun_ddgi": (("ddgi",), (S, S, True)),
        "camera_helmet": (("helmet",), (H, W, False)),
    }
    launches = {e: sum(by_kind[k].get(shape, 0) for k in kinds)
                for e, (kinds, shape) in entries.items()}
    if not all(launches.values()):
        raise AssertionError(f"a raster of the frames' path was never launched: {launches}")

    print(card)
    rows = [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches[name],
        "launches_forward_slice": slice1_launches.get(entries[name][1], 0),
        **timed[name], "library_ms": None,
    } for name in entries]

    def trace_row(t, launches):
        return {
            "name": f"bvh_trace ({t['name']})", "route": "cuda", "source": TRACE_SOURCE,
            "replaces": TRACE_REPLACES, "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "share": t["share"],
            "rays": t["rays"], "steps": t["steps"], "library_ms": None,
        }

    rows += [trace_row(t, trace_launches.get(t["name"], 0)) for t in traces]
    rows += [trace_row(t, by_label.get(t["trace"], 0)) for by_label, t in kind_traces]
    if not all(row["launches"] for row in rows):
        raise AssertionError("a kernel of the frames' path was never launched")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
