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
     shadow map: 10 captured frames (3 warm-up, 7 timed) and 3 eager ones
     for the per-pass table, finite LDR, non-empty coverage, raster kernel
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
     (LocalShadow) frames, 3 warm-up + 7 timed (captured) + 3 eager and 3 replayed as
     per-pass graphs (the per-pass tables) + 2 counted frames each:
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
     the bench as in phase 8, each of the 2 counted frames finite, covered
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
     bounces, AgX, AA: 3 warm-up + 7 timed samples; finite radiance and
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
 16. the showcase app (arkoserenderer_torch/apps/showcase.py) at 1920x1080
     in this process, through its build_scene, make_renderer, render and
     main: (a) --texture-quality stochastic1 --ssao --motion-blur --dof
     --ssss --fog --frames 8 --timings --timings-deadline 30, with the
     stochastic VSM tap (shadow_filter="stochastic" through make_renderer):
     every frame finite, the frame loop's rasters by shape as implied (the
     camera every frame, the 1024^2 sun once), the per-pass table and
     <frame> ms, the PNG read back as a (1080, 1920, 3) uint8 image with a
     std above 5, and the last camera (tile 8x16, 512 a tile) and sun rasters
     the run made held bit for bit against the plain raster and timed as in
     phase 3; VisibilityShading's ms under stochastic1 against trilinear on
     the same scene (Renderer.benchmark, in turns, with the per-pass table
     of each flag set's second run); then the Renderer API:
     a checkpoint after 3 frames restored into a fresh renderer gives the
     uninterrupted frame 4 within 1e-5, validate_frame finds nothing,
     pick at the centre pixel hits an instance, memstats reports the bytes
     in use; (b) --texture-quality aniso4 --rt-shadows --rt-reflections
     --ddgi --frames 4 through main, its traversal launches by label as
     implied, its per-pass table (Renderer.benchmark, 4 frames), then
     every trace of one more frame bit for bit against the plain walk and
     timed; (c) --pathtracer --samples 2 through main: a
     finite PNG and its traces launched;
 17. translucency and the reference shading mode: (a) the bench's
     translucent kind at 1920x1080 (the forward scene with the two panes of
     tests/test_translucent.py, oit_layers=4, tile 8x128) through the bench
     as in phase 8, a frame's rasters being the camera's, four peel layers
     and the cached sun; ForwardTranslucent's ms at 4 layers and at 1, and
     peak memory; then every raster of one more frame captured, each peel
     layer (the camera's shape, each below the last layer's depth) held bit
     for bit against the plain raster and timed as in phase 3; the panes
     blend: at 1080p the pixels they cover differ from the frame without
     them, and by less than 0.95-alpha panes move them; (b) the 96^2 two-pane frame
     at 1 and 4 layers and the 128^2 forward frame under
     shading_mode="reference", each rendered on the card and on the CPU,
     within the goldens' bound of each other; (c) the forward kind at
     1920x1080 under shading_mode="reference" and packed, in turns, their
     ms/frame and VisibilityShading ms; (d) the showcase app at 1920x1080
     on the .arklvl of tools/ark_level.write_level (binary and JSON
     .arkmsh, a PNG-textured and a translucent .arkmat, an .arkset, a BC7
     .dds sky), --oit-layers 2 --frames 4 --timings: the level's
     instances, lights and environment map in the scene, its frames finite,
     the launches as implied, and one more frame's peel layers at the app's
     tile 8x16 bit for bit and timed.
 18. hair, streaming, the overlays and the other apps, at full size, each
     through the entry point a user calls with the launch counts zeroed
     just before it and read just after: (a) humandemo --orbit at
     1920x1080, 8 frames (hair, SSSS, the rim spot, tile 8x16, 512 a tile,
     a 1024^2 sun rastered every frame under hair): its rasters as implied,
     ms/frame by CUDA events and the host's clock, the per-pass table, hair
     pixels on screen, then one more frame's camera raster (with the
     ribbons) and sun raster bit for bit against the plain raster and
     timed; (b) a StreamingManager at its default 4 MiB budget streaming as
     many spheres into the rt scene (1920x1080) as the pools and the
     parked TLAS slots take during 8 timed frames: bytes a tick, the frame
     all are LOADED, ms/frame with ticks, without, and of the scene without
     them, every pool tensor's storage kept, the traces of one more frame
     on the refitted BVH bit for bit against the plain walk, the streamed
     forward frame within 1e-5 of a scene built with the spheres and the
     streamed rt frame within the goldens' bound of it; (c) the showcase app
     with --debug-draw --light-icons --ddgi --ddgi-probe-debug at
     1920x1080, 4 frames: the three overlays' ms, and the card's 128^2
     frame (two overlapping point-light icons and a spot added) against the
     CPU's (mean abs diff < 0.3 of 255, no value off by more than 24);
     (d) geodata at 1920x1080 at --grid 257 and 1025 (about 2.1M
     triangles): ms/frame, Geometry and SunShadow ms, the triangles after
     culling, the dropped bin entries, peak memory, and the camera raster
     bit for bit and timed; (e) meshviewer on the DamagedHelmet at 1024^2:
     the lit turntable (4 frames, the camera raster bit for bit and timed)
     and --view normal, the PNGs checked.
 19. the live viewer and its systems: (a) ``apps/viewer.main`` at 1920x1080
     in a thread, 24 frames on a free port, driven over HTTP: ``w`` down and
     up, a click on the sphere at the frame's centre (the pick selects it),
     ``select 0``, ``g`` and ``ArrowUp`` held; the PNG, /stats and
     /hierarchy read back; the moved instance's world on the device equal
     to the host's; a camera and a 512^2 sun raster every frame (and
     time_passes' on frame 0); frames a second of the loop, ms/frame by
     CUDA events and by the host's clock, the LDR's readback and
     encode_png's ms each frame, the per-pass table of one --timings-every
     frame; then the viewer's camera and sun rasters bit for bit against
     the plain raster and timed as in phase 3; (b) the same scripted
     session through the viewer loop at 128^2 (fixed dt) on the card and on
     the CPU: transforms and camera equal, the last LDR within the goldens'
     bound; (c) BuiltinPhysicsBackend's stack of four boxes and a thrown
     ball committed each frame into Renderer(dynamic_transforms=True) at
     1920x1080, 16 frames: ms/frame, the host's step + commit and upload
     ms, peak memory, the bodies' coverage moving every frame, the vertex
     and index pools kept; (d) hot reload: a ModuleWatcher poll after a
     watched module changes, reconstruct(rebuild_passes=True) on (a)'s
     renderer keeping TAAHistory bit for bit, ops/raster_cuda reloaded and
     the next frame's rasters through the kernel with build/kernels
     unchanged; (e) profiling.trace around two frames with a zone each: the
     trace names the zones and raster_tiles_kernel, the renderer's
     arkose.frame#<i> spans (camera, fill, replay within) nest inside them,
     and the frame record's timestamps pair with the trace's
     frame_stamp_kernel launches (the clock fit's residual); (f) meshviewer
     --interactive on the DamagedHelmet at 1024^2 over HTTP, 4 frames.
 20. pixel-band sharding (parallel/sharded.py) through ``run_bands``, the
     ranks sharing this card over gloo (CUDA tensors; and over NCCL, one
     rank a card, when the machine has two cards, else a line says it was
     not run): (a) n = 2, the forward slice (no TAA, no Bloom) at 1920x1080
     with tile 4x128 (the only tile that splits 1080 rows into two bands of
     whole tiles) and the 8192^2 sun, 2 frames: each rank's rasters are one
     1920x540 camera band a frame and one 8192x4096 sun band (cached), each
     bit for bit against the plain raster at its y_offset; the gathered LDR
     against the unsharded card frame at the same tile (unequal values,
     largest difference, the share off by > 1e-5 below 1e-3); (b) n = 4 at
     1920x1024 (tile 8x128) on the rt_soft scene with Bloom, SSAO, soft RT
     sun and spot shadows, RT reflections and DDGI, no TAA, 3 frames: the
     same bound, every band raster and every trace of the last frame bit
     for bit against the plain versions, the replicated stages (the RT
     denoisers' whole-frame outputs, the DDGI atlases) equal on all ranks by
     SHA-256; (c) per rank ms/frame (CUDA events), the collectives' count,
     ms and bytes a frame, backend and peak memory; then rank 1's band
     rasters of (a) and (b) timed as in phase 3, and the last rank's
     traces of (b) as in phase 10. One card shared by gloo
     ranks makes (c) a correctness run, not a scaling measurement.
 21. the reduced-rate paths at 1920x1080, each run through the bench
     (``run_config(..., rates=)``: 2 warm-up + 4 timed + 2 counted frames,
     the camera moving) with the launch counts zeroed just before it and read
     just after: (a) rt and rt_soft at rt_scale 1 and 2: ms/frame and the
     per-pass table of each, the traces by label as the bench implies them
     (five a frame at either rate), the half-rate frame's LDR against the
     full-rate one after the same frames within tests/test_rt_passes.py's
     bound (mean abs < 0.02, < 6 % of pixels off by > 0.1), then one more
     half-rate frame's traces (the sun mask and the reflections at 518,400
     rays) held bit for bit against the plain walk and timed; (b) ddgi and
     showcase at ddgi_sample_scale 1 and 2: LightingCompose's ms, ms/frame,
     finite LDR and coverage in every counted frame, the traces by label;
     (c) forward at sky_fetch_scale 1 and 2: SkyView's ms. In every run, one
     more frame's rasters are held bit for bit against the plain raster;
 22. the captured frame (``RenderPipeline.compile``: the whole frame in CUDA
     graphs, which every Renderer frame of the phases above already ran
     through) against the eager one, for every single-card kind at
     1920x1080: phase 5's forward slice and the bench's Renderer kinds. Each
     renders the same 10 frames from frame 0 (the same camera path)
     eagerly and captured; the captured display image and every persistent
     tensor equal the eager run's bit for bit; each run's raster and
     traversal launches, replays included, equal bench.expected_*; and it
     prints "captured" or "eager: <what blocks it>", captured against eager
     ms/frame (median of frames 4-9 by CUDA events) and host wall ms/frame,
     the kernel ms of one more captured frame (torch.profiler's CUDA
     activity; the eager frame launches the same kernels), the busy share of
     each mode (that over its unprofiled median) and peak
     memory (the graph's pool included). Then the same 10 frames replay as
     the captured frame's chain of per-pass graphs (``pass_events``: one
     graph a pass, a CUDA event between each two): its display image and
     persistent state equal the whole-frame graph's bit for bit, its
     launches the bench's, and its passes' medians (frames 4-9) sum to
     within 5 % of the whole-frame graph's ms/frame; it prints that
     per-pass table. Frames that must see each kernel call (the rasters and
     traces held bit for bit above) run eagerly
     (``rendering/pipeline.eager_frames``);
 23. the reference's last jitted steps and branches on the card: (a) the
     pathtraced kind at 1920x1080 (3 bounces, AA): 16 samples eager, then 16
     captured (``PathTracer`` replays a CUDA graph of one sample): the
     accumulation and the LDR bit for bit, seven traces a sample by label in
     each (replays counted), ms/sample and host wall ms/sample of each, the
     kernel ms of one profiled captured sample and the busy share of each,
     both modes in turns (8 samples a block, E C C E), peak memory; the
     reset on a camera move (captured against eager) and a checkpoint round
     trip, bit for bit, the accumulation keeping its storage; then the
     256^2 pathtraced golden through the captured sample; (c) the phase-18
     streaming of spheres into the rt scene at 1920x1080 three ways: a tick
     (staging chunks, non_blocking copies) between replays of the captured
     frame, eager streaming, and blocking writes (`scene.write_rows`, no staging) between
     replays: all 16 frames bit for bit, every pool tensor keeping its
     storage, the host ms of a tick (staged against blocking) and ms/frame
     with ticks against without; (d) rt_soft and forward_upscaled with a
     still camera (the denoisers' and TemporalUpscale's nine-shift history
     fetch) and with a 0.3 m pan a frame (the gather): 8 frames eager and
     captured, held as in phase 22, the per-pass chain's display
     image and state bit for bit, and the chain's RTShadow, RTReflections and
     TemporalUpscale ms; (e) the reference shading mode under
     texture_quality="sorted": the card's 128^2 frame against the port's
     on the CPU (tests/test_torch_reference_frames.py's bound: under 0.2 %
     of values off by > 2e-4, means within 1e-5), and VisibilityShading's
     ms at 1920x1080 (per-pass graphs and eager) against trilinear.
 24. the reference's last traversal and raster entry points and its offline
     tools (run_slice19): (a) ``ops/raster.rasterize`` at 1920x1080, tile
     8x128, over a seeded clip-space soup of 4,096 triangles, one raster
     kernel launch, vis and depth bit for bit against the plain raster on
     its setup and bins and timed as in phase 3; at 256x192 over 300
     two-sided triangles against ``ops/raster_reference.rasterize_numpy``
     (tests/test_raster.py's bounds: coverage equal, under 0.1 % of ids
     differing, depth within 1e-5); (b) the rt scene's BVH and 16,384
     seeded rays: closest and any hit through the traversal kernel against
     ``trace_rays_brute`` (tests/test_bvh.py's bounds), measured as in
     phase 10; the same BVH without its wide records through the binary
     walk on the card (closest-hit hit and tri equal to the kernel's, t
     within 1e-5; any-hit hit equal), the flat BVH of the same triangles
     through the flat walk against brute force, and a chunked any-hit
     trace with per-ray t_max equal to the unchunked one bit for bit; (c)
     a scene built without a BVH: its placeholder misses every ray and
     ``trace_shadow_mask`` is all lit; (d) ``shade_hits_simple`` on (b)'s
     hits, its occlusion trace through the kernel, equal bit for bit to the
     same call through the plain walk, measured as in phase 10; (e)
     ``python -m arkoserenderer_torch.tools.cooker`` on a rules file with
     gltf (the DamagedHelmet at max_texture 256), image, bc7, ies, hair and
     copy rules in a temporary directory; a second run rebuilds nothing,
     touching one input rebuilds its two outputs only; the baked helmet
     (``assets/baked.load_baked``) renders one 512x512 frame on the card
     through the raster kernel, finite and covered. Each part's kernel
     counts are set to 0 just before it and read just after.
The line before the last is the kernels' JSON: one entry per raster the
raster kernel serves (1080p camera, cached sun, local shadow, stress
camera, per-frame stress sun, 720p camera, flagship camera, ddgi camera,
per-frame ddgi sun, helmet camera, the app's camera and sun, the translucent
kind's and the app's peel layers, humandemo's camera with hair and its sun,
the terrain cameras at both grids, meshviewer's 1024^2 helmet camera and
the live viewer's camera and per-frame 512^2 sun, phase 20's 1920x540 and
1920x256 camera bands and 8192x4096 sun band, phase 24's rasterize soup),
each with its launches in the runs of the frame kinds or apps that launch
it, and one entry per trace the traversal kernel serves in the rt,
showcase, flagship, ddgi, helmet and rt_soft frames, the pathtraced sample,
the AO bake, the app's RT frame, the streamed rt frame, the last
rank's band of phase 20 (b), phase 21's half-rate rt and rt_soft
frames and phase 24's closest, any-hit and simple-occlusion traces, each
with its launches by its label in that run;
the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FRAMES, WARMUP = 10, 3
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


# Phase 16: the showcase app's argv, at 1920x1080.
APP_SIZE = ["--width", "1920", "--height", "1080"]
APP_STOCHASTIC = ["--texture-quality", "stochastic1", "--ssao", "--motion-blur", "--dof",
                  "--ssss", "--fog", "--frames", "8", "--timings", "--timings-deadline", "30"]
APP_RT = ["--texture-quality", "aniso4", "--rt-shadows", "--rt-reflections", "--ddgi",
          "--frames", "4"]
APP_PATHTRACER = ["--pathtracer", "--samples", "2"]
# Phase 17: the translucent kind's peel layers, and the app's on the level.
TRANSLUCENT_LAYERS, APP_LEVEL_LAYERS = 4, 2
APP_LEVEL = ["--oit-layers", str(APP_LEVEL_LAYERS), "--frames", "4", "--timings"]
# Phase 18: the slice's apps, streaming and overlays at full size.
HUMAN_ARGV = ["--frames", "8", "--orbit"]
OVERLAY_FLAGS = ["--debug-draw", "--light-icons", "--ddgi", "--ddgi-probe-debug"]
STREAM_FRAMES = 8
TERRAIN_GRIDS = (257, 1025)
VIEWER_SIZE = 1024
# Phase 19: the live viewer's frames, the scripted session's size, the
# physics frames and meshviewer --interactive's frames.
VIEWER_FRAMES, SESSION_SIZE, PHYSICS_FRAMES, MESHVIEWER_FRAMES = 24, 128, 16, 4


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


def golden_bound(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(mean abs diff, share of values off by > 24) of two uint8 images:
    the goldens' measure."""
    diff = np.abs(a.astype(int) - b.astype(int))
    return float(diff.mean()), float((diff > 24).mean())


def check_golden(name: str, img: torch.Tensor) -> None:
    """Hold a 256x256 LDR image rendered on the card against
    tests/goldens/<name>.png under the golden test's thresholds."""
    from arkoserenderer_torch.utils.imageio import load_png, to_u8

    golden = load_png(str(ROOT / "tests" / "goldens" / f"{name}.png"))[..., :3]
    mean, off = golden_bound(to_u8(img.cpu().numpy()), golden)
    if not (mean < 1.5 and off < 0.005):
        raise AssertionError(f"golden {name}: mean abs diff {mean:.4f}, {off:.4%} pixels off "
                             "by > 24")
    print(f"golden {name} 256x256 on the card: mean abs diff {mean:.4f} (< 1.5), "
          f"{off:.4%} pixels off by > 24 (< 0.5%)", flush=True)


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
    print(f"per-pass median ms after the timed frames: {result['pass_ms_from']} (pass_ms), "
          f"eager frames (eager_pass_ms) [{card}]:")
    for name, ms in result["eager_pass_ms"].items():
        print(f"  {name:20s} {result['pass_ms'].get(name, float('nan')):10.4f} {ms:10.4f}")
    print(f"  {'sum of passes':20s} {sum(result['pass_ms'].values()):10.4f} "
          f"{sum(result['eager_pass_ms'].values()):10.4f}", flush=True)


def check_png(path: Path, size: tuple[int, int] = (1080, 1920)) -> None:
    """An app's PNG read back through the port's reader: (height, width,
    3|4) uint8 with a std above 5."""
    from arkoserenderer_torch.utils.imageio import load_png

    img = load_png(str(path))
    if img.shape[:2] != tuple(size) or img.shape[2] not in (3, 4) \
            or img.dtype != np.uint8 or not img.std() > 5:
        raise AssertionError(f"{path.name}: {img.shape} {img.dtype}, std {img.std():.3f}")


def run_app(dev, card: str, compare_and_time, check_kind_traces) -> dict:
    """Phase 16: the showcase app's three runs and the Renderer API at
    1920x1080 (see the module docstring). Returns {"traces": the RT run's
    measured traces with its launches by label, "raster_launches": the
    app's camera and sun raster launches}."""
    from arkoserenderer_torch.apps import showcase
    from arkoserenderer_torch.ops import raster_cuda
    from arkoserenderer_torch.rendering.pipeline import validate_frame
    from arkoserenderer_torch.tools import bench
    from arkoserenderer_torch.tools import raster_bench as rb
    from arkoserenderer_torch.tools import trace_bench as tb
    from arkoserenderer_torch.utils import memstats

    H, W, S = 1080, 1920, 1024
    raster_k = raster_cuda.rasterize_tiles_cuda
    trace_k = tb.bvh_cuda.trace_rays_cuda
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()

    # (a) the stochastic frame, with the stochastic VSM tap.
    args = showcase.build_arg_parser().parse_args(
        APP_SIZE + APP_STOCHASTIC + ["--out", str(out_dir / "app_stochastic.png")])

    def stochastic_renderer():
        scene, cam = showcase.build_scene(args)
        return showcase.make_renderer(args, scene, cam, dev, shadow_filter="stochastic")

    r = stochastic_renderer()
    finite, loop_counts = [], []
    render_frame = r.render_frame

    def checked_frame(*a, **kw):
        img = render_frame(*a, **kw)
        finite.append(torch.isfinite(img).all())  # read after the run
        loop_counts.append(dict(raster_k.launches_by_shape))
        return img

    r.render_frame = checked_frame
    raster_k.launches_by_shape.clear()
    rasters, result = rb.capture_rasters(lambda: showcase.render(args, r))
    by_shape_a = dict(raster_k.launches_by_shape)
    del r.render_frame
    n = 1 + args.frames
    want = bench.expected_launches_by_shape(r, n)
    if len(finite) != n or not all(bool(f) for f in finite) or loop_counts[n - 1] != want:
        raise AssertionError(f"app (a): {len(finite)} frames, finite {[bool(f) for f in finite]}, "
                             f"rasters {loop_counts[-1:]} against {want}")
    check_png(Path(args.out))
    timings = result["timings"]
    if "<frame>" not in timings or "VisibilityShading" not in timings:
        raise AssertionError(f"app (a): per-pass table {timings}")
    print(f"app (a) {W}x{H} stochastic1 + stochastic VSM, SSAO, MotionBlur, DoF, SSSS, Fog: "
          f"{n} frames finite, {result['ms_per_frame']:.4f} ms/frame (host clock over "
          f"{args.frames}), <frame> {timings['<frame>']:.4f} ms (CUDA events), frame-loop "
          f"rasters {loop_counts[n - 1]}, rasters in the run with --timings {by_shape_a} "
          f"[{card}]", flush=True)
    app_raster = r.cfg.raster
    compare_and_time("camera_app", f"app camera {W}x{H}, tile 8x16 (512 a tile)", 2,
                     *rasters[H, W, False], rcfg=app_raster)
    compare_and_time("sun_app", f"app sun {S}x{S} depth-only", 5, *rasters[S, S, True],
                     rcfg=app_raster)
    del rasters

    # VisibilityShading under stochastic1 against trilinear, in turns.
    tri_args = showcase.build_arg_parser().parse_args(
        APP_SIZE + ["--ssao", "--motion-blur", "--dof", "--ssss", "--fog"])
    r_tri = showcase.make_renderer(tri_args, *showcase.build_scene(tri_args), dev)
    for i, (name, renderer) in enumerate((("stochastic1", r), ("trilinear", r_tri),
                                          ("trilinear", r_tri), ("stochastic1", r))):
        res = renderer.benchmark(warmup=2, iters=6)
        print(f"app VisibilityShading {name}: {res['eager_pass_ms']['VisibilityShading']:.4f} ms "
              f"(median of 6), frame {res['ms_per_frame']:.4f} ms [{card}]", flush=True)
        if i >= 2:
            print(f"app (a) flags under {name}, in the frame:")
            print_frame_table(res, card)
    del r, r_tri

    # The Renderer API at 1920x1080.
    ckpt = out_dir / "app_checkpoint.npz"
    r1 = stochastic_renderer()
    for _ in range(3):
        r1.render_frame()
    r1.save_checkpoint(str(ckpt))
    expected = r1.render_frame().clone()
    del r1
    r2 = stochastic_renderer()
    r2.load_checkpoint(str(ckpt))
    err = (r2.render_frame() - expected).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"app checkpoint: resumed frame 4 differs by {err}")
    inputs = {k: r2.state[k] for k in r2.pipeline.registry.persistent_names if k in r2.state}
    findings = validate_frame(r2.pipeline, inputs, r2.scene_arrays,
                              r2.camera.state(r2.frame_index, dev), r2.frame_index)
    hit = r2.pick(W // 2, H // 2)
    snap = memstats.snapshot(dev)
    history = memstats.MemHistory()
    history.poll(dev)
    if findings or hit["instance"] < 0 or snap.bytes_in_use <= 0:
        raise AssertionError(f"app API: validate_frame {findings}, pick {hit}, memory {snap}")
    print(f"app API {W}x{H}: checkpoint after 3 frames resumed, frame 4 max diff {err:.3e} "
          f"(<= 1e-5); validate_frame: no finding; pick({W // 2}, {H // 2}) = {hit}; "
          f"memstats: {history.format()} [{card}]", flush=True)
    del r2

    # (b) the anisotropic RT frame, through main.
    out_b = out_dir / "app_rt.png"
    raster_k.launches_by_shape.clear()
    trace_k.launches_by_label.clear()
    r_b = showcase.main(APP_SIZE + APP_RT + ["--out", str(out_b)], device=dev)
    raster_b, trace_b = dict(raster_k.launches_by_shape), dict(trace_k.launches_by_label)
    n_b = 1 + 4
    want_t = bench.expected_trace_launches_by_label(r_b, n_b)
    if trace_b != want_t or raster_b != bench.expected_launches_by_shape(r_b, n_b):
        raise AssertionError(f"app (b): traces {trace_b} against {want_t}, rasters {raster_b}")
    check_png(out_b)
    print(f"app (b) {W}x{H} aniso4, RT shadows and reflections, DDGI: {n_b} frames, traversal "
          f"launches {trace_b}, rasters {raster_b} [{card}]", flush=True)
    print_frame_table(r_b.benchmark(warmup=1, iters=4), card)
    cases = tb.kind_traces(r_b, "app")
    grid = next(p.grid for p in r_b.pipeline.passes if p.name == "DDGI")
    traces = check_kind_traces("app", {"trace_launches": trace_b,
                                       "trace_launches_expected": want_t},
                               cases, grid.probes_per_frame * grid.rays_per_probe)
    del r_b, cases

    # (c) the path tracer, through main.
    out_c = out_dir / "app_pathtraced.png"
    trace_k.launches_by_label.clear()
    tracer = showcase.main(APP_SIZE + APP_PATHTRACER + ["--out", str(out_c)], device=dev)
    trace_c = dict(trace_k.launches_by_label)
    if trace_c != bench.expected_trace_launches_by_label(tracer, 2) or not bool(
            torch.isfinite(tracer.radiance()).all()):
        raise AssertionError(f"app (c): traces {trace_c}, radiance finite "
                             f"{bool(torch.isfinite(tracer.radiance()).all())}")
    check_png(out_c)
    print(f"app (c) {W}x{H} path tracer, 2 samples: finite, traversal launches {trace_c}; "
          f"phase 16 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del tracer
    return {"traces": traces,
            "raster_launches": {"camera_app": by_shape_a[H, W, False] + raster_b[H, W, False],
                                "sun_app": by_shape_a[S, S, True]}}


def run_translucency(dev, card: str, compare_and_time, run_kind) -> dict:
    """Phase 17 (see the module docstring). Returns {"timed": the peel
    rasters' measurements by entry ("peel", "peel_app"), "launches": the
    peel launches of the runs that made them}."""
    import dataclasses
    import tempfile

    from arkoserenderer_torch.apps import showcase
    from arkoserenderer_torch.assets import ark
    from arkoserenderer_torch.assets.procedural import add_glass_panes, build_test_scene
    from arkoserenderer_torch.core.types import RasterConfig, SceneLimits
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops import raster_cuda
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_torch.scene.scene import Scene
    from arkoserenderer_torch.tools import bench
    from arkoserenderer_torch.tools import raster_bench as rb
    from arkoserenderer_torch.tools.ark_level import write_level
    from arkoserenderer_torch.utils.imageio import to_u8

    H, W = 1080, 1920
    kernel = raster_cuda.rasterize_tiles_cuda
    t_phase = time.perf_counter()
    timed, launches = {}, {}

    def peel_layers(calls, layers):
        """The peel layers among one frame's rasters: of the camera-sized
        ones (shadow maps aside), the camera's first, then the layers,
        layer 0 unlimited."""
        shapes = [(c["height"], c["width"], c["depth_only"]) for c in calls]
        frame = [c for c, shape in zip(calls, shapes) if shape == (H, W, False)]
        limits = [c["depth_limit"] is not None for c in frame]
        if limits != [False, False] + [True] * (layers - 1):
            raise AssertionError(f"a translucent frame rastered {shapes}, limits {limits}")
        return frame[1:]

    # (a) the translucent kind at 1920x1080, four layers.
    res, r, by_shape = run_kind("translucent")
    n = res["frames"]
    if by_shape[(H, W, False)] != (1 + TRANSLUCENT_LAYERS) * n or "ForwardTranslucent" not in \
            res["eager_pass_ms"]:
        raise AssertionError(f"translucent: rasters {by_shape} in {n} frames, passes "
                             f"{list(res['eager_pass_ms'])}")
    launches["peel"] = by_shape[(H, W, False)] - n
    calls, _ = rb.capture_raster_calls(lambda: r.render_frame())
    layers = [compare_and_time("peel", f"translucent peel layer {i} {W}x{H}, tile 8x128"
                               f"{', depth_limit' if c['depth_limit'] is not None else ''}", 2,
                               c["setup"], c["bins"], W, H, False, r.cfg.raster,
                               depth_limit=c["depth_limit"])
              for i, c in enumerate(peel_layers(calls, TRANSLUCENT_LAYERS))]
    timed["peel"] = dict(layers[1], per_layer=layers)
    del r, calls

    scene, cam, cfg, kw = bench.build_scene("translucent")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    r1 = Renderer(scene, cam, cfg, device=dev, **dict(kw, oit_layers=1))
    one = r1.benchmark(warmup=2, iters=8, before_frame=bench.camera_mover(r1))
    peel_ms = res["eager_pass_ms"]["ForwardTranslucent"]
    print(f"translucent {W}x{H}: ForwardTranslucent {peel_ms:.4f} "
          f"ms at {TRANSLUCENT_LAYERS} layers (frame {res['ms_per_frame']:.4f}, peak memory "
          f"{res['peak_memory_gib']:.3f} GiB), {one['eager_pass_ms']['ForwardTranslucent']:.4f} "
          f"ms at "
          f"1 layer (frame {one['ms_per_frame']:.4f}, median of 8, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB) [{card}]", flush=True)
    del r1

    def pane_frame(alpha):
        sc, cm = build_test_scene(viewport=(W, H))
        if alpha is not None:
            add_glass_panes(sc, alpha=alpha)
        rr = Renderer(sc, cm, bench.pipeline_config(), device=dev, taa=False, bloom=False,
                      oit_layers=TRANSLUCENT_LAYERS)
        return rr.render_frame().float()

    img_none, img_05, img_95 = (pane_frame(a) for a in (None, 0.5, 0.95))
    d_05 = (img_05 - img_none).abs().mean(-1)
    changed = d_05 > 0.02
    d_95 = (img_95 - img_none).abs().mean(-1)[changed].mean().item()
    if not (bool(torch.isfinite(img_05).all()) and changed.sum().item() > 1000
            and d_05[changed].mean().item() < d_95):
        raise AssertionError(f"translucent {W}x{H}: {changed.sum().item()} pane pixels, "
                             f"alpha 0.5 moves them {d_05[changed].mean().item():.4f}, 0.95 "
                             f"{d_95:.4f}")
    print(f"translucent {W}x{H} blend: {changed.sum().item()} pixels moved by the panes "
          f"(> 0.02), by {d_05[changed].mean().item():.4f} at alpha 0.5 and {d_95:.4f} at "
          f"0.95 (less: the background shows through) [{card}]", flush=True)
    del img_none, img_05, img_95, d_05, changed

    # (b) the card against the port on the CPU, same inputs.
    tile16 = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256)
    for label, size, n_layers, mode in (("two panes 96x96, 1 layer", 96, 1, "packed"),
                                        ("two panes 96x96, 4 layers", 96, 4, "packed"),
                                        ("forward 128x128, reference mode", 128, 1,
                                         "reference")):
        imgs = []
        for device in (dev, "cpu"):
            sc, cm = build_test_scene(viewport=(size, size), n_spheres=1 if size == 96 else 3)
            if size == 96:
                add_glass_panes(sc)
            c = PipelineConfig(width=size, height=size, raster=tile16, shadow_map_size=128,
                               shading_mode=mode)
            imgs.append(Renderer(sc, cm, c, device=device, taa=False, bloom=False,
                                 oit_layers=n_layers).render_frame().cpu().numpy())
        mean, off = golden_bound(*(to_u8(img) for img in imgs))
        if not (np.isfinite(imgs[0]).all() and mean < 1.5 and off < 0.005):
            raise AssertionError(f"{label}: card vs CPU mean abs diff {mean}, {off:.4%} off")
        print(f"{label} card vs CPU: mean abs diff {mean:.4f} (< 1.5), {off:.4%} of values "
              f"off by > 24 (< 0.5%) [{card}]", flush=True)

    # (c) the reference shading mode at 1920x1080, against packed, in turns.
    renderers = {}
    for mode in ("packed", "reference"):
        sc, cm, c, kw_ = bench.build_scene("forward")
        renderers[mode] = Renderer(sc, cm, dataclasses.replace(c, shading_mode=mode),
                                   device=dev, **kw_)
    for i, mode in enumerate(("packed", "reference", "reference", "packed")):
        rr = renderers[mode]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        out = rr.benchmark(warmup=2, iters=8, before_frame=bench.camera_mover(rr))
        ldr = rr.state["LDR"]
        if not bool(torch.isfinite(ldr).all()) or (mode == "reference") == (
                "vis.records" in rr.state):
            raise AssertionError(f"forward {mode}: LDR finite {bool(torch.isfinite(ldr).all())}, "
                                 f"state {sorted(rr.state)}")
        print(f"forward {W}x{H} shading_mode={mode}: {out['ms_per_frame']:.4f} ms/frame (median "
              f"of 8; min {min(out['frame_ms']):.4f}, max {max(out['frame_ms']):.4f}), "
              f"VisibilityShading {out['eager_pass_ms']['VisibilityShading']:.4f} ms, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB [{card}]", flush=True)
        if i == 2:
            print_frame_table(out, card)
    del renderers, rr

    # (d) the showcase app on a level in the reference's formats.
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        paths = write_level(Path(tmp))
        info = ark.load_arklvl(Scene(SceneLimits()), paths["level"])
        args = showcase.build_arg_parser().parse_args(
            APP_SIZE + ["--gltf", str(paths["level"])] + APP_LEVEL
            + ["--out", str(out_dir / "app_level.png")])
        scene, cam = showcase.build_scene(args)
        n_lights = int(scene.sun is not None) + len(scene.spots) + len(scene.points)
        if not (info["env"] and info["instances"] == len(scene.instances) == 6
                and info["lights"] == n_lights == 3 and scene.env_map.shape == (32, 64, 3)
                and scene.static_info().has_translucent):
            raise AssertionError(f"app level: {info}, {len(scene.instances)} instances, "
                                 f"{n_lights} lights, sky {scene.env_map.shape}")
        r = showcase.make_renderer(args, scene, cam, dev)
    finite, loop_counts = [], []
    render_frame = r.render_frame

    def checked_frame(*a, **kw_):
        img = render_frame(*a, **kw_)
        finite.append(torch.isfinite(img).all())
        loop_counts.append(dict(kernel.launches_by_shape))
        return img

    r.render_frame = checked_frame
    kernel.launches_by_shape.clear()
    result = showcase.render(args, r)
    del r.render_frame
    frames = 1 + args.frames
    want = bench.expected_launches_by_shape(r, frames)
    if len(finite) != frames or not all(bool(f) for f in finite) or \
            loop_counts[frames - 1] != want:
        raise AssertionError(f"app level: {len(finite)} frames, rasters {loop_counts[-1:]} "
                             f"against {want}")
    check_png(Path(args.out))
    launches["peel_app"] = loop_counts[frames - 1][(H, W, False)] - frames
    print(f"app {W}x{H} on the .arklvl (6 instances, sun + spot + point, BC7 sky loaded): "
          f"{frames} frames finite, {result['ms_per_frame']:.4f} ms/frame (host clock over "
          f"{args.frames}), <frame> {result['timings']['<frame>']:.4f} ms (CUDA events), "
          f"ForwardTranslucent {result['timings']['ForwardTranslucent']:.4f} ms, frame-loop "
          f"rasters {loop_counts[frames - 1]} [{card}]", flush=True)
    calls, _ = rb.capture_raster_calls(lambda: r.render_frame())
    app_layers = [compare_and_time("peel_app", f"app peel layer {i} {W}x{H}, tile 8x16"
                                   f"{', depth_limit' if c['depth_limit'] is not None else ''}",
                                   2, c["setup"], c["bins"], W, H, False, r.cfg.raster,
                                   depth_limit=c["depth_limit"])
                  for i, c in enumerate(peel_layers(calls, APP_LEVEL_LAYERS))]
    timed["peel_app"] = dict(app_layers[1], per_layer=app_layers)
    del r, calls
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return {"timed": timed, "launches": launches}


def tensor_pointers(tree, prefix: str = "") -> dict:
    """{field path: data_ptr()} of every tensor of a SceneArrays (nested
    tuples and the BVH's dataclass included)."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.data_ptr()
    elif hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            out.update(tensor_pointers(v, f"{prefix}{k}."))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(tensor_pointers(v, f"{prefix}{i}."))
    elif tree is not None and hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            out.update(tensor_pointers(getattr(tree, k), f"{prefix}{k}."))
    return out


def overlay_lights(scene) -> None:
    """Two point lights a few pixels apart and a spot in view of the test
    scene's camera: their icons overlap, so the overlay scatter has
    collisions to resolve."""
    from arkoserenderer_torch.scene.lights import PointLight, SpotLight

    scene.points += [PointLight(position=np.array([0.0, 1.8, 0.0], np.float32),
                                color=np.array([1.0, 0.2, 0.1], np.float32)),
                     PointLight(position=np.array([0.04, 1.82, 0.0], np.float32),
                                color=np.array([0.1, 1.0, 0.3], np.float32))]
    scene.spots.append(SpotLight(position=np.array([-1.0, 2.0, 0.5], np.float32),
                                 direction=np.array([0.0, -1.0, 0.0], np.float32),
                                 color=np.array([0.2, 0.4, 1.0], np.float32)))


def stream_worlds(scene) -> tuple:
    """(the rt scene's first sphere segment, a shared static BLAS; a world
    matrix for each of as many more instances of it as the pools and the
    parked TLAS slots hold, in rows in front of the camera)."""
    seg = 1
    lim, mirror, sphere = scene.limits, scene._mirror, scene.segments[seg]
    n = min(lim.max_drawables - len(scene.instances), len(scene._bvh_stream["free"]),
            (lim.max_vertices - mirror["v_cursor"]) // sphere.positions.shape[0],
            (lim.max_triangles - mirror["t_cursor"]) // sphere.num_triangles)
    if n < 16:
        raise AssertionError(f"streaming: room for {n} instances only")
    xs = np.linspace(-4.5, 4.5, 8)
    worlds = []
    for i in range(n):
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (xs[i % 8], 0.3 + 0.9 * (i // 32), -5.0 + 1.25 * ((i // 8) % 4) + 0.6 * (i % 2))
        worlds.append(w)
    return seg, worlds


def timed_frames(step, frames: int) -> dict:
    """``step()`` ``frames`` times, each under CUDA events and the host's
    clock (synchronised): per-frame ms of both, and their medians."""
    dev_ms, host_ms = [], []
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return {"ms": dev_ms, "host_ms": host_ms, "median_ms": float(np.median(dev_ms)),
            "median_host_ms": float(np.median(host_ms))}


def run_slice13(dev, card: str, compare_and_time, check_kind_traces, width: int = 1920,
                height: int = 1080, small: bool = False, grids=TERRAIN_GRIDS,
                viewer: int = VIEWER_SIZE) -> dict:
    """Phase 18 (see the module docstring): humandemo, streaming on the rt
    scene, the overlays through the showcase app, geodata at two grids and
    meshviewer on the helmet, at ``width`` x ``height`` (the bench's
    ``small`` rt scene for a rehearsal at a small size). Returns
    {"raster_launches": the main paths' launches of the new raster entries,
    "traces": the streamed frame's measured traces with its launches by
    label}."""
    from arkoserenderer_torch.apps import geodata, humandemo, meshviewer, showcase
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops import raster_cuda
    from arkoserenderer_torch.rendering.streaming import LOADED, StreamingManager
    from arkoserenderer_torch.tools import bench
    from arkoserenderer_torch.tools import raster_bench as rb
    from arkoserenderer_torch.tools import trace_bench as tb
    from arkoserenderer_torch.utils.imageio import to_u8

    H, W = height, width
    size = ["--width", str(W), "--height", str(H)]
    raster_k = raster_cuda.rasterize_tiles_cuda
    trace_k = tb.bvh_cuda.trace_rays_cuda
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    launches, traces = {}, []

    # (a) humandemo at 1920x1080: hair ribbons, SSSS, the rim spot, --orbit.
    out = out_dir / "humandemo.png"
    raster_k.launches_by_shape.clear()
    r = humandemo.main(size + HUMAN_ARGV + ["--out", str(out)], device=dev)
    by_shape = dict(raster_k.launches_by_shape)
    S = r.cfg.shadow_map_size
    want = bench.expected_launches_by_shape(r, 8)
    if by_shape != want or want.get((S, S, True)) != 8 or "SSSS" not in [
            p.name for p in r.pipeline.passes]:
        raise AssertionError(f"humandemo: rasters {by_shape} against {want}")
    check_png(out, (H, W))
    launches["camera_hair"], launches["sun_hair"] = by_shape[H, W, False], by_shape[S, S, True]
    res = r.benchmark(warmup=1, iters=8,
                      before_frame=lambda i: humandemo.orbit(r.camera, i % 8, 8))
    vis = r.state["Visibility"]
    orig = r.state["vis.setup"].orig_tri[vis[vis >= 0].long()]
    hair_px = int((r.scene_arrays.tri_instance[orig.long()] == len(r.scene.instances) - 1).sum())
    if hair_px <= 0 or not bool(torch.isfinite(r.state["LDR"]).all()):
        raise AssertionError(f"humandemo: {hair_px} hair pixels")
    print(f"humandemo {W}x{H} (hair, SSSS, spot, --orbit): rasters in main's 8 frames "
          f"{by_shape}; {res['ms_per_frame']:.4f} ms/frame (CUDA events, median of 8), "
          f"{res['wall_ms_per_frame']:.4f} ms/frame (host clock), {hair_px} hair pixels "
          f"[{card}]", flush=True)
    print_frame_table(res, card)
    rasters, _ = rb.capture_rasters(lambda: r.render_frame())
    compare_and_time("camera_hair", f"humandemo camera {W}x{H} with hair ribbons, tile 8x16 "
                     "(512 a tile)", 2, *rasters[H, W, False], rcfg=r.cfg.raster)
    compare_and_time("sun_hair", f"humandemo sun {S}x{S} depth-only, every frame", 5,
                     *rasters[S, S, True], rcfg=r.cfg.raster)
    del r, rasters

    # (b) streaming into the rt scene under the default 4 MiB budget.
    scene, cam, cfg, kw = bench.build_scene("rt", small)
    r = Renderer(scene, cam, cfg, device=dev, **kw)
    seg, worlds = stream_worlds(scene)
    n = len(worlds)
    r.render_frame()
    ptrs = tensor_pointers(r.scene_arrays)
    mgr = StreamingManager(scene)
    tickets = [mgr.enqueue_instance(seg, w) for w in worlds]
    ticks, loaded_at = [], None

    def stream_step():
        nonlocal loaded_at
        r.scene_arrays = mgr.tick(r.scene_arrays)
        ticks.append(mgr.bytes_uploaded_last_tick)
        if loaded_at is None and all(t.state == LOADED for t in tickets):
            loaded_at = len(ticks)
        r.render_frame()

    raster_k.launches_by_shape.clear()
    trace_k.launches_by_label.clear()
    with_ticks = timed_frames(stream_step, STREAM_FRAMES)
    stream_rasters, stream_traces = dict(raster_k.launches_by_shape), dict(
        trace_k.launches_by_label)
    want_r = bench.expected_launches_by_shape(r, STREAM_FRAMES)
    want_t = bench.expected_trace_launches_by_label(r, STREAM_FRAMES)
    active = int(r.scene_arrays.bvh.inst_active.sum())
    if stream_rasters != want_r or stream_traces != want_t or loaded_at is None or \
            mgr.pending or active != len(scene.instances):
        raise AssertionError(f"streaming: rasters {stream_rasters} against {want_r}, traces "
                             f"{stream_traces} against {want_t}, loaded after {loaded_at}, "
                             f"{active} active TLAS slots for {len(scene.instances)} instances")
    if tensor_pointers(r.scene_arrays) != ptrs:
        raise AssertionError("streaming replaced a pool tensor")
    without = timed_frames(r.render_frame, STREAM_FRAMES)
    twin = Renderer(*bench.build_scene("rt", small)[:3], device=dev, **kw)
    twin.render_frame()
    plain = timed_frames(twin.render_frame, STREAM_FRAMES)
    del twin
    print(f"streaming {n} spheres into the rt scene {W}x{H} (4 MiB a tick, "
          f"{sum(t.bytes_total for t in tickets)} bytes in all): bytes a tick {ticks}, all "
          f"LOADED after {loaded_at} frame(s); every pool tensor kept its storage; frames with "
          f"ticks {[round(x, 4) for x in with_ticks['ms']]} ms (CUDA events; host clock "
          f"{[round(x, 4) for x in with_ticks['host_ms']]}), then without ticks median "
          f"{without['median_ms']:.4f} ms (host {without['median_host_ms']:.4f}), the scene "
          f"without the spheres median {plain['median_ms']:.4f} ms (host "
          f"{plain['median_host_ms']:.4f}) [{card}]", flush=True)
    cases = tb.kind_traces(r, "stream")
    if any(c["bvh"] is not r.scene_arrays.bvh for c in cases):
        raise AssertionError("a streamed frame's trace walked another BVH than the scene's")
    traces += check_kind_traces("stream", {"trace_launches": stream_traces,
                                           "trace_launches_expected": want_t}, cases, 0)
    res = r.benchmark(warmup=1, iters=8)
    print(f"streamed rt scene {W}x{H}, {len(scene.instances)} instances: "
          f"{res['ms_per_frame']:.4f} ms/frame (median of 8) [{card}]", flush=True)
    print_frame_table(res, card)
    del r, cases, mgr

    def streamed_and_rebuilt(flags, after):
        """The streamed frame ``after`` frames past the stream, and the frame
        of the same index from a Renderer built with the spheres."""
        sc, cm, cf, _ = bench.build_scene("rt", small)
        rs = Renderer(sc, cm, cf, device=dev, taa=False, bloom=False, **flags)
        rs.render_frame()
        for w in worlds:
            rs.scene_arrays = sc.stream_instance(rs.scene_arrays, seg, w)
        for _ in range(after):
            img_s = rs.render_frame()
        sc, cm, cf, _ = bench.build_scene("rt", small)
        for w in worlds:
            sc.add_instance(seg, w)
        rr = Renderer(sc, cm, cf, device=dev, taa=False, bloom=False, **flags)
        for _ in range(rs.frame_index):
            img_r = rr.render_frame()
        return img_s.float(), img_r.float()

    img_s, img_r = streamed_and_rebuilt({}, 1)
    err = (img_s - img_r).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"streamed forward frame differs from the rebuilt one by {err}")
    print(f"streamed forward frame {W}x{H} (SunShadow + LocalShadow) against the rebuilt "
          f"scene's: max abs diff {err:.3e} (<= 1e-5) [{card}]", flush=True)
    img_s, img_r = streamed_and_rebuilt(dict(rt_shadows=True, rt_reflections=True), 8)
    mean, off = golden_bound(to_u8(img_s.cpu().numpy()), to_u8(img_r.cpu().numpy()))
    if not (mean < 1.5 and off < 0.005):
        raise AssertionError(f"streamed rt frame: mean abs diff {mean}, {off:.4%} off by > 24")
    print(f"streamed rt frame {W}x{H} 8 frames on against the rebuilt scene's (a streamed TLAS "
          f"leaf against a rebuilt tree): mean abs diff {mean:.4f} of 255 (< 1.5), {off:.4%} "
          f"of values off by > 24 (< 0.5%) [{card}]", flush=True)
    del img_s, img_r

    # (c) the overlays through the showcase app at 1920x1080, 4 frames.
    out = out_dir / "app_overlays.png"
    raster_k.launches_by_shape.clear()
    trace_k.launches_by_label.clear()
    r = showcase.main(size + OVERLAY_FLAGS + ["--frames", "4", "--out", str(out)], device=dev)
    by_shape, by_label = dict(raster_k.launches_by_shape), dict(trace_k.launches_by_label)
    names = [p.name for p in r.pipeline.passes]
    if by_shape != bench.expected_launches_by_shape(r, 5) or \
            by_label != bench.expected_trace_launches_by_label(r, 5) or \
            names[-3:] != ["DebugDraw", "DDGIProbeDebug", "IconBillboards"]:
        raise AssertionError(f"app overlays: rasters {by_shape}, traces {by_label}, passes "
                             f"{names}")
    check_png(out, (H, W))
    res = r.benchmark(warmup=1, iters=4)
    print(f"app {W}x{H} --debug-draw --light-icons --ddgi --ddgi-probe-debug: 5 frames, "
          f"rasters {by_shape}, traces {by_label}; DebugDraw "
          f"{res['eager_pass_ms']['DebugDraw']:.4f} ms, DDGIProbeDebug "
          f"{res['eager_pass_ms']['DDGIProbeDebug']:.4f} ms, IconBillboards "
          f"{res['eager_pass_ms']['IconBillboards']:.4f} ms (no local light in the app's scene), "
          f"frame {res['ms_per_frame']:.4f} ms (median of 4) [{card}]", flush=True)
    print_frame_table(res, card)
    del r
    imgs = []
    for device in (dev, "cpu"):
        args = showcase.build_arg_parser().parse_args(
            ["--width", "128", "--height", "128"] + OVERLAY_FLAGS)
        sc, cm = showcase.build_scene(args)
        overlay_lights(sc)
        rr = showcase.make_renderer(args, sc, cm, device)
        rr.render_frame()
        imgs.append(to_u8(rr.render_frame().cpu().numpy()).astype(int))
    diff = np.abs(imgs[0] - imgs[1])
    if not (diff.mean() < 0.3 and diff.max() <= 24):
        raise AssertionError(f"app overlays 128^2 card vs CPU: mean {diff.mean()}, max "
                             f"{diff.max()}")
    print(f"app overlays 128x128 (+ 2 point lights and a spot: icons that overlap) card vs CPU: "
          f"mean abs diff {diff.mean():.4f} of 255 (< 0.3), max {diff.max()} (<= 24) [{card}]",
          flush=True)

    # (d) geodata at 1920x1080: the app's grid and 1025^2.
    for grid in grids:
        out = out_dir / f"geodata_{grid}.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        raster_k.launches_by_shape.clear()
        t0 = time.perf_counter()
        r = geodata.main(size + ["--frames", "4", "--grid", str(grid), "--out", str(out)],
                         device=dev)
        host_s = time.perf_counter() - t0
        by_shape = dict(raster_k.launches_by_shape)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if by_shape != bench.expected_launches_by_shape(r, 4):
            raise AssertionError(f"geodata {grid}: rasters {by_shape}")
        check_png(out, (H, W))
        launches[f"camera_terrain_{grid}"] = by_shape[H, W, False]
        res = r.benchmark(warmup=1, iters=8)
        counts = bench.frame_counts(r)
        tris = [s.num_triangles for s in r.scene.segments]
        print(f"geodata --grid {grid} {W}x{H}: {tris} triangles (fine, coarse), main() "
              f"{host_s:.2f} s with the build; {res['ms_per_frame']:.4f} ms/frame (median of "
              f"8), Geometry {res['eager_pass_ms']['Geometry']:.4f} ms, SunShadow "
              f"{res['eager_pass_ms']['SunShadow']:.4f} ms; after culling "
              f"{counts['visible_tris']} "
              f"triangles, dropped bin entries camera {counts['overflow_camera']} sun "
              f"{counts['overflow_sun']}; peak memory {peak:.3f} GiB [{card}]", flush=True)
        print_frame_table(res, card)
        rasters, _ = rb.capture_rasters(lambda: r.render_frame())
        compare_and_time(f"camera_terrain_{grid}", f"geodata camera {W}x{H}, --grid {grid}, "
                         "tile 8x16 (512 a tile)", 1, *rasters[H, W, False], rcfg=r.cfg.raster)
        del r, rasters

    # (e) meshviewer on the DamagedHelmet at 1024^2.
    helmet = ROOT / "assets" / "sample" / "DamagedHelmet" / "DamagedHelmet.gltf"
    V = viewer
    raster_k.launches_by_shape.clear()
    r = meshviewer.main([str(helmet), "--frames", "4", "--size", str(V), "--out",
                         str(out_dir / "meshviewer_{frame}.png")], device=dev)
    by_shape = dict(raster_k.launches_by_shape)
    if by_shape != bench.expected_launches_by_shape(r, 4):
        raise AssertionError(f"meshviewer: rasters {by_shape}")
    for f in range(4):
        check_png(out_dir / f"meshviewer_{f}.png", (V, V))
    launches["camera_helmet_1024"] = by_shape[V, V, False]
    rasters, _ = rb.capture_rasters(lambda: r.render_frame())
    compare_and_time("camera_helmet_1024", f"meshviewer helmet camera {V}x{V}, tile 8x16 "
                     "(512 a tile)", 2, *rasters[V, V, False], rcfg=r.cfg.raster)
    del r, rasters
    r = meshviewer.main([str(helmet), "--frames", "2", "--size", str(V), "--view", "normal",
                         "--out", str(out_dir / "meshviewer_normal_{frame}.png")], device=dev)
    for f in range(2):
        check_png(out_dir / f"meshviewer_normal_{f}.png", (V, V))
    if r.pipeline.passes[-1].name != "DebugVisualize":
        raise AssertionError("meshviewer --view normal: no DebugVisualize pass")
    print(f"meshviewer DamagedHelmet {V}x{V}: lit turntable 4 frames (rasters {by_shape}) and "
          f"--view normal 2 frames, PNGs checked; phase 18 took "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del r
    return {"raster_launches": launches, "traces": traces}


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class HttpClient:
    """GETs and POSTs against a local viewer; raises if the serving
    thread has failed (``result["error"]``)."""

    def __init__(self, port: int, result: dict):
        self.base = f"http://127.0.0.1:{port}"
        self.result = result

    def get(self, path: str) -> bytes:
        import urllib.request

        self.check()
        return urllib.request.urlopen(self.base + path, timeout=120).read()

    def post(self, ev: dict) -> None:
        import urllib.request

        self.check()
        rq = urllib.request.Request(self.base + "/event", data=json.dumps(ev).encode(),
                                    method="POST")
        urllib.request.urlopen(rq, timeout=120).read()

    def stats(self) -> dict:
        return json.loads(self.get("/stats"))

    def check(self) -> None:
        if "error" in self.result:
            raise AssertionError(f"the viewer's thread failed: {self.result['error']}")

    def first_png(self, timeout_s: float = 300.0) -> bytes:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            try:
                png = self.get("/frame.png")
                if png:
                    return png
            except OSError:
                pass
            time.sleep(0.05)
        raise AssertionError(f"no frame served within {timeout_s} s")

    def wait(self, cond, frames_timeout_s: float = 120.0) -> dict:
        """Poll /stats until ``cond(stats)``; returns the stats."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < frames_timeout_s:
            st = self.stats()
            if cond(st):
                return st
            time.sleep(0.01)
        raise AssertionError(f"the viewer's stats never met the condition: {self.stats()}")


def serve_in_thread(fn, result: dict):
    """Run ``fn()`` in a daemon thread; its return value lands in
    result["value"], its exception (repr) in result["error"]."""
    import threading

    def body():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - the main thread raises it
            result["error"] = repr(e)
            raise

    th = threading.Thread(target=body, daemon=True)
    th.start()
    return th


def join_served(th, result: dict, what: str) -> object:
    th.join(timeout=600)
    if th.is_alive() or "error" in result:
        raise AssertionError(f"{what}: thread alive {th.is_alive()}, {result.get('error')}")
    return result["value"]


# Phase 19 (b): the scripted session (frame, method, args); the click lands
# on the middle sphere at the frame's centre, the select picks the box.
def session_script(size: int) -> list:
    c = size // 2
    return [
        (0, "push_key_down", ("w",)), (0, "push_mouse_move", (10.0, 5.0)),
        (1, "click", (c, c)),
        (2, "push_key_up", ("w",)), (2, "push_key_down", ("ArrowRight",)),
        (3, "push_key_down", ("g",)), (3, "push_key_down", ("PageUp",)),
        (4, "push_key_up", ("g",)),
        (5, "push_key_down", ("g",)), (5, "push_mouse_move", (4.0, 9.0)),
        (6, "push_key_up", ("g",)), (6, "push_key_up", ("ArrowRight",)), (6, "select", (4,)),
        (7, "push_key_up", ("PageUp",)), (7, "push_key_down", ("ArrowUp",)),
    ]


def physics_stack_scene(width: int, height: int):
    """Phase 19 (c): the test scene (one sphere, the physics' ball) with a
    stack of four unit boxes over the floor; returns (scene, camera, instance ids of the
    boxes, the sphere's instance)."""
    from arkoserenderer_torch.assets.procedural import build_test_scene, make_box
    from arkoserenderer_torch.scene.scene import Material

    scene, cam = build_test_scene(viewport=(width, height), n_spheres=1)
    mat = scene.add_material(Material(base_color_factor=np.array([0.85, 0.6, 0.2, 1.0],
                                                                 np.float32),
                                      roughness_factor=0.5))
    box = make_box((1.0, 1.0, 1.0))
    box.material = mat
    seg = scene.add_segment(box)
    boxes = []
    for k in range(4):
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (1.6, 0.5 + 1.001 * k, 0.6)
        boxes.append(scene.add_instance(seg, w))
    return scene, cam, boxes, 1


def run_slice14(dev, card: str, compare_and_time, width: int = 1920, height: int = 1080,
                frames: int = VIEWER_FRAMES, timings: bool = True,
                session: int = SESSION_SIZE, helmet_size: int = VIEWER_SIZE) -> dict:
    """Phase 19 (see the module docstring): the live viewer through
    ``viewer.main`` over HTTP, a scripted session card against CPU, physics
    into a dynamic Renderer, hot reload, profiling and meshviewer
    --interactive. Returns {"raster_launches": the viewer's camera and sun
    rasters' launches in (a)}."""
    import importlib

    from arkoserenderer_torch.apps import meshviewer, viewer
    from arkoserenderer_torch.models import standard
    from arkoserenderer_torch.ops import raster_cuda
    from arkoserenderer_torch.physics.backend import (
        BodyDesc,
        BuiltinPhysicsBackend,
        PhysicsScene,
    )
    from arkoserenderer_torch.system.webviewer import WebSystem
    from arkoserenderer_torch.tools import bench
    from perfbench.lib.records import clock_fit
    from arkoserenderer_torch.tools import raster_bench as rb
    from arkoserenderer_torch.utils import profiling
    from arkoserenderer_torch.utils.hotreload import ModuleWatcher
    from arkoserenderer_torch.utils.imageio import decode_png, to_u8

    H, W = height, width
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()

    def counts() -> dict:
        # Looked up each time: (d) reloads the wrapper's module.
        return dict(raster_cuda.rasterize_tiles_cuda.launches_by_shape)

    def zero_counts() -> None:
        raster_cuda.rasterize_tiles_cuda.launches_by_shape.clear()

    # (a) the live viewer through viewer.main, driven over HTTP.
    class TimedWebSystem(WebSystem):
        """The web System, timing each present: the LDR's copy to the
        host and encode_png, and when the frame was presented."""

        def __init__(self, port):
            super().__init__(port=port)
            self.readback_ms, self.encode_ms, self.presented_at = [], [], []

        def present(self, ldr_image):
            t0 = time.perf_counter()
            host = ldr_image.cpu()
            t1 = time.perf_counter()
            super().present(host)
            t2 = time.perf_counter()
            self.readback_ms.append((t1 - t0) * 1e3)
            self.encode_ms.append((t2 - t1) * 1e3)
            self.presented_at.append(t2)

    events, holder = [], {}
    plain_render = standard.Renderer.render_frame

    def timed_render(self, *a, **kw):
        holder["renderer"] = self
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = plain_render(self, *a, **kw)
        end.record()
        events.append((start, end, t0))
        return out

    port = free_port()
    sysb = TimedWebSystem(port)
    argv = ["--width", str(W), "--height", str(H), "--port", str(port), "--frames", str(frames)]
    if timings:
        argv += ["--timings-every", "1000"]  # the per-pass table on frame 0 only
    result = {}
    standard.Renderer.render_frame = timed_render
    zero_counts()
    try:
        th = serve_in_thread(lambda: viewer.main(argv, device=dev, system=sysb), result)
        client = HttpClient(port, result)
        png = client.first_png()
        client.post({"type": "keydown", "key": "w"})
        n0 = client.wait(lambda s: s["frame"] >= 1)["frame"]
        client.wait(lambda s: s["frame"] >= n0 + 2)
        client.post({"type": "keyup", "key": "w"})
        client.post({"type": "click", "x": W // 2, "y": H // 2})
        picked = client.wait(lambda s: s.get("selected", -1) >= 0)["selected"]
        client.post({"type": "select", "instance": 0})
        client.wait(lambda s: s.get("selected") == 0)
        client.post({"type": "keydown", "key": "g"})
        client.post({"type": "keyup", "key": "g"})
        st = client.wait(lambda s: s.get("gizmo", "translate") != "translate")
        client.post({"type": "keydown", "key": "ArrowUp"})
        n1 = client.wait(lambda s: s["frame"] >= st["frame"] + 1)["frame"]
        client.wait(lambda s: s["frame"] >= n1 + 3)
        client.post({"type": "keyup", "key": "ArrowUp"})
        page = client.get("/")
        last_png = client.get("/frame.png")
        stats = client.stats()
        hier = json.loads(client.get("/hierarchy"))
        rc = join_served(th, result, "viewer.main")
    finally:
        standard.Renderer.render_frame = plain_render
    by_shape = counts()
    r = holder["renderer"]
    scene = r.scene
    torch.cuda.synchronize()
    dev_ms = [s.elapsed_time(e) for s, e, _ in events]
    host_ms = [(p - t0) * 1e3 - rd - enc for (_, _, t0), p, rd, enc in
               zip(events, sysb.presented_at, sysb.readback_ms, sysb.encode_ms)]
    img = decode_png(last_png)
    want = bench.expected_launches_by_shape(r, frames)
    if timings:  # time_passes: three whole frames, then Geometry and SunShadow twice each
        want = {k: v + 5 for k, v in want.items()}
    S = r.cfg.shadow_map_size
    world_dev = r.scene_arrays.world[0].cpu().numpy()
    checks = {
        "rc": rc == 0, "png": decode_png(png).shape == (H, W, 3) and img.shape == (H, W, 3)
        and img.std() > 5, "page": b"viewer" in page,
        "frames": stats["frame"] >= 1 and stats["ms"] > 0
        and len(dev_ms) == len(sysb.presented_at) == frames,
        "picked the centre's sphere": picked == 2,
        "selected": stats["selected"] == 0, "gizmo": stats["gizmo"] == "rotate",
        "hierarchy": len(hier) == len(scene.instances) and hier[0]["instance"] == 0,
        "moved on the device as on the host": np.array_equal(world_dev, scene.instances[0][1])
        and not np.array_equal(world_dev, np.eye(4, dtype=np.float32)),
        "rasters": by_shape == want and want == {(H, W, False): frames + 5 * timings,
                                                 (S, S, True): frames + 5 * timings},
        "timings": not timings or {"<frame>", "Geometry", "SunShadow"} <= set(stats["timings"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"viewer: failed {[k for k, v in checks.items() if not v]}: "
                             f"stats {stats}, rasters {by_shape} against {want}, picked {picked}")
    span = sysb.presented_at[-1] - sysb.presented_at[0]
    launches = {"camera_viewer": by_shape[H, W, False], "sun_viewer": by_shape[S, S, True]}
    print(f"viewer {W}x{H} through viewer.main over HTTP ({frames} frames, tile 8x16, 512 a "
          f"tile, {S}^2 sun every frame): {(frames - 1) / span:.4f} frames a second of the "
          f"loop; ms/frame median {np.median(dev_ms):.4f} by CUDA events, "
          f"{np.median(host_ms):.4f} by the host's clock (render_frame + synchronise; the "
          f"stats' ms {stats['ms']:.4f}, an EMA); the LDR's readback median "
          f"{np.median(sysb.readback_ms):.4f} ms, encode_png (zlib 6) median "
          f"{np.median(sysb.encode_ms):.4f} ms a frame; rasters {by_shape} (with time_passes' "
          f"on frame 0); picked instance {picked}, then selected 0, gizmo {stats['gizmo']} "
          f"[{card}]", flush=True)
    print(f"  per frame: CUDA events {[round(x, 4) for x in dev_ms]}")
    print(f"  host clock {[round(x, 4) for x in host_ms]}")
    print(f"  readback {[round(x, 4) for x in sysb.readback_ms]}")
    print(f"  encode_png {[round(x, 4) for x in sysb.encode_ms]}", flush=True)
    if timings:
        print(f"  per-pass table of frame 0 (utils/timing.time_passes, iters=1) [{card}]:")
        for name, ms in stats["timings"].items():
            print(f"    {name:20s} {ms:10.4f}")
    # The viewer's camera and sun rasters, bit for bit and timed.
    rasters, _ = rb.capture_rasters(lambda: r.render_frame())
    compare_and_time("camera_viewer", f"viewer camera {W}x{H}, tile 8x16 (512 a tile)", 2,
                     *rasters[H, W, False], rcfg=r.cfg.raster)
    compare_and_time("sun_viewer", f"viewer sun {S}x{S} depth-only, every frame "
                     "(dynamic_transforms)", 5, *rasters[S, S, True], rcfg=r.cfg.raster)
    del rasters

    # (d) hot reload: a watched module changes; reconstruct on the viewer's renderer.
    hot_dir = out_dir / "hot"
    hot_dir.mkdir(exist_ok=True)
    mod_file = hot_dir / "chip_hot_module.py"
    mod_file.write_text("VALUE = 1\n")
    sys.path.insert(0, str(hot_dir))
    kernels_dir = raster_cuda.BUILD_DIR
    built = {p.name: p.stat().st_mtime_ns for p in kernels_dir.iterdir()}
    try:
        hot = importlib.import_module("chip_hot_module")
        watcher = ModuleWatcher(roots=[str(hot_dir)], poll_interval=0.0)
        mod_file.write_text("VALUE = 2\n")
        os.utime(mod_file, (time.time() + 2, time.time() + 2))
        t0 = time.perf_counter()
        reloaded = watcher.poll()
        history = r.state["TAAHistory"].clone()
        r.reconstruct(rebuild_passes=True)
        torch.cuda.synchronize()
        reload_ms = (time.perf_counter() - t0) * 1e3
        kept = torch.equal(r.state["TAAHistory"], history)
        # The kernel wrapper's own module reloaded: its library handle resets,
        # and the next launch loads the library already built.
        lib_name = raster_cuda.build_kernels()._name
        raster_cuda = importlib.reload(raster_cuda)
        if raster_cuda._lib is not None:
            raise AssertionError("reloading ops/raster_cuda.py kept the library handle")
        zero_counts()
        r.render_frame()
        torch.cuda.synchronize()
        after = counts()
        hot_ok = reloaded == ["chip_hot_module"] and hot.VALUE == 2 and kept
        lib_ok = raster_cuda._lib is not None and raster_cuda._lib._name == lib_name
    finally:
        sys.path.remove(str(hot_dir))
        sys.modules.pop("chip_hot_module", None)
    now = {p.name: p.stat().st_mtime_ns for p in kernels_dir.iterdir()}
    if not (hot_ok and lib_ok and now == built and after == {(H, W, False): 1, (S, S, True): 1}):
        raise AssertionError(f"hot reload: reloaded {reloaded}, TAAHistory kept {kept}, library "
                             f"{lib_ok}, build/kernels unchanged {now == built}, rasters {after}")
    print(f"hot reload: ModuleWatcher.poll reloaded {reloaded}; poll + "
          f"reconstruct(rebuild_passes=True) on the {W}x{H} viewer renderer {reload_ms:.2f} ms; "
          f"TAAHistory equal bit for bit across it; ops/raster_cuda reloaded, the next frame's "
          f"rasters {after} through the CUDA kernel loading {Path(lib_name).name}; build/kernels "
          f"unchanged ({len(now)} files) [{card}]", flush=True)

    # (e) profiling: a trace of two frames with a zone each. The renderer's
    # own zones (arkose.frame#<i> and its children) nest inside them, and
    # the frames' record timestamps map onto the trace's clock.
    for _ in range(2):  # the graphs of the steady frames captured outside the trace
        r.render_frame()
    torch.cuda.synchronize()
    profiling.reset_zones()
    log_dir = out_dir / "trace"
    shutil.rmtree(log_dir, ignore_errors=True)
    first = r.frame_index
    with profiling.trace(str(log_dir), device=dev):
        for i in range(2):
            with profiling.zone(f"viewer frame {i}"):
                r.render_frame()
                torch.cuda.synchronize()
    traces = sorted(log_dir.glob("*.pt.trace.json"))
    text = traces[0].read_text() if traces else ""
    zones = profiling.zone_averages()
    if len(traces) != 1 or "viewer frame 0" not in text or "viewer frame 1" not in text \
            or "raster_tiles_kernel" not in text \
            or not {"viewer frame 0", "viewer frame 1", "arkose.frame"} <= set(zones):
        raise AssertionError(f"profiling: traces {traces}, zones {zones}, raster_tiles_kernel "
                             f"named {'raster_tiles_kernel' in text}")
    events = [e for e in json.loads(text)["traceEvents"] if e.get("ph") == "X"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}

    def inside(a, b) -> bool:
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    nested = []
    for i in range(2):
        outer, frame = spans.get(f"viewer frame {i}"), spans.get(f"arkose.frame#{first + i}")
        kids = [spans.get(f"arkose.frame.{k}#{first + i}") for k in ("camera", "fill", "replay")]
        if outer is None or frame is None or None in kids or not inside(frame, outer) \
                or not all(inside(k, frame) for k in kids):
            raise AssertionError(f"profiling: frame {first + i}'s arkose.frame spans missing or "
                                 f"not nested: {sorted(n for n in spans if 'arkose' in n)}")
        nested.append(f"arkose.frame#{first + i}")
    rows = r.frame_records()
    keep = (rows["frame_index"] >= first) & (rows["frame_index"] < first + 2)
    stamps = rows["stamps_ns"][keep].reshape(-1).astype(np.float64)
    starts = sorted(e["ts"] for e in events
                    if e.get("cat") == "kernel" and "frame_stamp_kernel" in e.get("name", ""))
    if len(starts) != len(stamps) or (np.diff(stamps) < 0).any():
        raise AssertionError(f"profiling: {len(starts)} frame_stamp_kernel launches in the trace "
                             f"against {len(stamps)} record timestamps {stamps}")
    residual = np.abs(clock_fit(starts, stamps)[1])
    drift = (np.polyfit(stamps * 1e-3, starts, 1)[0] - 1.0) * 1e6  # trace us per record us
    print(f"profiling.trace: {traces[0].name} ({len(text)} bytes) names both zones and "
          f"raster_tiles_kernel; {nested} nest inside them with their camera, fill and replay "
          f"spans; zone_averages {zones} ms; the record's {len(stamps)} timestamps of the two "
          f"frames on the trace's clock: |residual| median {np.median(residual):.3f} us, max "
          f"{residual.max():.3f} us, the clocks' rates {drift:+.1f} ppm apart [{card}]",
          flush=True)
    del r, holder

    # (b) the scripted session through the viewer loop, the card against the CPU.
    script = session_script(session)
    sides = []
    for device in (dev, "cpu"):
        args = viewer.build_arg_parser().parse_args(
            ["--width", str(session), "--height", str(session), "--frames", "8"])
        rs = viewer.make_renderer(args, device)
        ss = viewer.ScriptedSystem(script, max_frames=8)
        ticks = iter(range(1 << 30))
        viewer.run(args, rs, ss, clock=lambda: next(ticks) / 60.0)
        sides.append((rs, ss))
    (rg, sg), (rc_, sc) = sides
    mean, off = golden_bound(to_u8(sg.last_frame.cpu().numpy()), to_u8(sc.last_frame.numpy()))
    same = all(np.array_equal(a[1], b[1]) and (a[2] is None) == (b[2] is None)
               and (a[2] is None or np.array_equal(a[2], b[2]))
               for a, b in zip(rg.scene.instances, rc_.scene.instances, strict=True))
    same &= np.array_equal(rg.camera.position, rc_.camera.position) and np.array_equal(
        rg.camera.orientation, rc_.camera.orientation)
    moved = [i for i, it in enumerate(rg.scene.instances) if it[2] is not None]
    if not (same and sg.stats["selected"] == sc.stats["selected"] == 4 and moved == [2, 4]
            and mean < 1.5 and off < 0.005):
        raise AssertionError(f"scripted session: transforms and camera equal {same}, selected "
                             f"{sg.stats['selected']} / {sc.stats['selected']}, moved {moved}, "
                             f"LDR mean abs diff {mean}, {off:.4%} off by > 24")
    print(f"scripted viewer session {session}x{session}, 8 frames at dt 1/60 (fly, pick, select, "
          f"gizmo translate / rotate / scale): instance transforms and camera equal card and CPU, "
          f"moved {moved}; last LDR mean abs diff {mean:.4f} of 255 (< 1.5), {off:.4%} of values "
          f"off by > 24 (< 0.5%) [{card}]", flush=True)
    del sides, rg, rc_

    # (c) physics committed into a dynamic Renderer at full size.
    scene, cam, boxes, sphere_inst = physics_stack_scene(W, H)
    args = viewer.build_arg_parser().parse_args(["--width", str(W), "--height", str(H)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    r = standard.Renderer(scene, cam, viewer.pipeline_config(args), device=dev,
                          dynamic_transforms=True)
    phys = BuiltinPhysicsBackend()
    phys.add_static_plane((0, 1, 0), 0.0)
    ps = PhysicsScene(phys, scene)
    for inst in boxes:
        body = phys.add_body(BodyDesc("box", np.array([0.5, 0.5, 0.5]), mass=1.0,
                                      restitution=0.0), scene.instances[inst][1][:3, 3])
        ps.attach(body, inst)
    ball = phys.add_body(BodyDesc("sphere", np.array([0.6] * 3), mass=4.0, restitution=0.3),
                         (-0.6, 1.4, 0.6), velocity=(5.0, 0.0, 0.0))
    ps.attach(ball, sphere_inst)
    upload_ms = []
    plain_upload = scene.update_instance_transforms

    def timed_upload(arrays):
        t0 = time.perf_counter()
        out = plain_upload(arrays)
        upload_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    scene.update_instance_transforms = timed_upload
    r.render_frame()
    before = r.scene_arrays
    pools = (before.positions.data_ptr(), before.indices.data_ptr())
    step_ms, frame_ms, coverage = [], [], []
    bodies = torch.tensor(boxes + [sphere_inst], device=dev)
    zero_counts()
    for _ in range(PHYSICS_FRAMES):
        t0 = time.perf_counter()
        for _ in range(2):
            phys.step(1 / 60.0)
        ps.commit()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ldr = r.render_frame()
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        if not bool(torch.isfinite(ldr).all()):
            raise AssertionError("physics: a frame is not finite")
        vis = r.state["Visibility"]
        inst = torch.full_like(vis, -1)
        hit = vis >= 0
        inst[hit] = r.scene_arrays.tri_instance[
            r.state["vis.setup"].orig_tri[vis[hit].long()].long()].int()
        coverage.append(torch.isin(inst, bodies).float().mean().item())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    by_shape = counts()
    world_ok = all(np.array_equal(r.scene_arrays.world[i].cpu().numpy(), scene.instances[i][1])
                   for i in boxes + [sphere_inst])
    moving = all(a != b for a, b in zip(coverage, coverage[1:]))
    if not (r.scene_arrays.positions is before.positions and r.scene_arrays.indices is
            before.indices and (r.scene_arrays.positions.data_ptr(),
                                r.scene_arrays.indices.data_ptr()) == pools
            and moving and min(coverage) > 0 and world_ok
            and by_shape == bench.expected_launches_by_shape(r, PHYSICS_FRAMES)):
        raise AssertionError(f"physics: pools kept {r.scene_arrays.positions is before.positions}"
                             f", the bodies' coverage {coverage}, world {world_ok}, rasters "
                             f"{by_shape}")
    print(f"physics into Renderer(dynamic_transforms=True) {W}x{H}: 4 stacked boxes and a "
          f"sphere thrown into them, {PHYSICS_FRAMES} frames (2 steps of 1/60 s each): ms/frame median "
          f"{np.median(frame_ms):.4f} by CUDA events; host ms of step + commit median "
          f"{np.median(step_ms):.4f}, of the transform upload median "
          f"{np.median(upload_ms[1:]):.4f}; peak memory {peak:.3f} GiB; the bodies' share of the "
          f"pixels, moving every frame, {[round(c, 4) for c in coverage]}; positions and "
          f"indices kept their storage; "
          f"rasters {by_shape} [{card}]", flush=True)
    print(f"  frames {[round(x, 4) for x in frame_ms]}")
    print(f"  step + commit {[round(x, 4) for x in step_ms]}", flush=True)
    del r, before, ldr, vis, inst

    # (f) meshviewer --interactive on the DamagedHelmet, over HTTP.
    helmet = ROOT / "assets" / "sample" / "DamagedHelmet" / "DamagedHelmet.gltf"
    V = helmet_size
    port = free_port()
    result = {}
    zero_counts()
    th = serve_in_thread(lambda: meshviewer.main(
        [str(helmet), "--interactive", "--size", str(V), "--frames", str(MESHVIEWER_FRAMES),
         "--port", str(port)], device=dev), result)
    client = HttpClient(port, result)
    first = decode_png(client.first_png())
    st = client.wait(lambda s: s["frame"] >= 1)
    r = join_served(th, result, "meshviewer --interactive")
    by_shape = counts()
    if first.shape != (V, V, 3) or not first.std() > 5 or not st["ms"] > 0 or \
            by_shape != bench.expected_launches_by_shape(r, MESHVIEWER_FRAMES):
        raise AssertionError(f"meshviewer --interactive: {first.shape}, stats {st}, rasters "
                             f"{by_shape}")
    print(f"meshviewer --interactive DamagedHelmet {V}x{V} over HTTP: {MESHVIEWER_FRAMES} orbit "
          f"frames, PNG {first.shape}, stats {st}, rasters {by_shape}; phase 19 took "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    del r
    return {"raster_launches": launches}


def band_records(res: dict, name: str, card: str) -> list:
    """Print (c) for each rank of a phase-20 run and check what every rank
    must show: a finite frame, every captured raster and trace equal to its
    plain version (``tools/shard_bench.rank_run`` raised otherwise), and the
    replicated stages' hashes equal on all ranks."""
    ranks = res["ranks"]
    for r in ranks:
        if not r["finite"]:
            raise AssertionError(f"{name}: rank {r['rank']}'s band is not finite")
        print(f"{name} rank {r['rank']} ({r['backend']}, {r['device']}): "
              f"{r['ms_per_frame']:.4f} ms/frame (CUDA events; host "
              f"{r['wall_ms_per_frame']:.4f}), collectives {r['collectives_per_frame']:.1f} a "
              f"frame taking {r['collective_ms_per_frame']:.4f} ms, "
              f"{r['gathered_mib_per_frame']:.3f} MiB gathered a frame, peak memory "
              f"{r['peak_gib']:.3f} GiB; rasters {r['raster_launches_by_shape']} "
              f"({len(r['rasters_equal'])} equal to the plain raster, y_offsets "
              f"{sorted({c['y_offset'] for c in r['rasters_equal']})}); traces "
              f"{r['trace_launches_by_label']} ({len(r['traces_equal'])} of the last frame "
              f"equal to the plain walk) [{card}]", flush=True)
    for key in ("cuts", "replicated"):
        if any(r[key] != ranks[0][key] for r in ranks):
            raise AssertionError(f"{name}: the replicated stages differ across ranks ({key}: "
                                 f"{[r[key] for r in ranks]})")
    print(f"{name}: {len(ranks[0]['cuts'])} replicated denoiser outputs and "
          f"{sorted(ranks[0]['replicated'])} equal bit for bit on all {len(ranks)} ranks "
          "(SHA-256)", flush=True)
    return ranks


def frame_agreement(name: str, ours: np.ndarray, ref: np.ndarray, card: str) -> None:
    """The gathered frame against the unsharded card frame, within
    tests/test_sharding.py's bound: the share of values off by more than
    1e-5 below 1e-3."""
    if ours.shape != ref.shape or not np.isfinite(ours).all():
        raise AssertionError(f"{name}: gathered frame {ours.shape}, expected {ref.shape}, finite")
    diff = np.abs(ours - ref)
    share = float((diff > 1e-5).mean())
    print(f"{name}: gathered LDR against the unsharded card frame: {int((diff > 0).sum())} of "
          f"{diff.size} values unequal, largest difference {float(diff.max()):.3e}, share "
          f"off by more than 1e-5 {share:.3e} (bound 1e-3) [{card}]", flush=True)
    if share >= 1e-3:
        raise AssertionError(f"{name}: the sharded frame diverges ({share:.4f} > 1e-3)")


def run_slice15(dev, card: str, compare_and_time, width: int = 1920, iters: int = 6) -> dict:
    """Phase 20: pixel-band sharding through ``parallel/sharded.run_bands``,
    the ranks sharing this card over gloo (and over NCCL, one rank a card,
    where the machine has the cards). Returns the band rows' launches and
    the last rank's measured band traces."""
    import functools

    from arkoserenderer_torch.assets.procedural import build_test_scene
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops import raster
    from arkoserenderer_torch.parallel.sharded import BandJob, band_config, run_bands
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_torch.tools import raster_bench as rb
    from arkoserenderer_torch.tools import shard_bench as sb
    from arkoserenderer_torch.tools import trace_bench as tb

    t_phase = time.perf_counter()
    S = 8192
    out = {"raster_launches": {}, "traces": []}

    # (a) n = 2, the forward slice at 1920x1080: only tile 4x128 splits 1080
    # rows into two bands of whole tiles (540 = 135 * 4).
    H = 1080
    rcfg = RasterConfig(tile_h=4, tile_w=128, max_tris_per_tile=256)
    cfg = PipelineConfig(width=width, height=H, raster=rcfg, shadow_map_size=S)
    kw = dict(taa=False, bloom=False)
    job = BandJob(functools.partial(build_test_scene, viewport=(width, H)), cfg, 2, kw)
    scene, cam = job.scene()
    ref = Renderer(scene, cam, cfg, device=dev, **kw)
    ref_ldr = ref.render_frames(job.frames).cpu().numpy()
    backends = [("gloo", ["cuda"] * 2)]
    if torch.cuda.device_count() >= 2:
        backends.append(("nccl", None))
    else:
        print("phase 20: NCCL across cards not run (one card)", flush=True)
    band_h = band_config(cfg, 2).height
    for backend, devices in backends:
        name = f"sharded forward n=2 {width}x{H} tile 4x128 ({backend})"
        res = run_bands(sb.rank_run, 2, backend, devices, job, iters)
        ranks = band_records(res, name, card)
        want = {f"{band_h}x{width}": job.frames, f"{S // 2}x{S} depth-only": 1}
        for r in ranks:
            if r["raster_launches_by_shape"] != want:
                raise AssertionError(f"{name}: rank {r['rank']} rastered "
                                     f"{r['raster_launches_by_shape']}, expected {want}")
        frame_agreement(name, res["ldr"], ref_ldr, card)
        if backend == "gloo":
            out["raster_launches"]["camera_band"] = sum(r["raster_launches_by_shape"][
                f"{band_h}x{width}"] for r in ranks)
            out["raster_launches"]["sun_band"] = sum(r["raster_launches_by_shape"][
                f"{S // 2}x{S} depth-only"] for r in ranks)
    # Rank 1's band rasters, timed as phase 3 times the whole ones.
    cases = rb.forward_raster_inputs(ref.scene_arrays, cam.state(0, dev), ref.cfg.scene, width,
                                     H, S, rcfg)
    cam_setup, sun_setup = cases["camera"][0], cases["sun"][0]
    del cases
    compare_and_time("camera_band", f"camera band {width}x{band_h} at y_offset {band_h}, tile "
                     "4x128", 5, cam_setup, raster.bin_triangles(cam_setup, width, band_h, rcfg,
                                                                 y_offset=band_h),
                     width, band_h, False, rcfg=rcfg, y_offset=band_h)
    compare_and_time("sun_band", f"sun band {S}x{S // 2} at y_offset {S // 2}, depth-only", 2,
                     sun_setup, raster.bin_triangles(sun_setup, S, S // 2, rcfg,
                                                     y_offset=S // 2),
                     S, S // 2, True, rcfg=rcfg, y_offset=S // 2)
    del ref, cam_setup, sun_setup

    # (b) n = 4 at 1920x1024: bloom (five levels in the frame and in a band),
    # SSAO, soft RT sun and spot shadows, RT reflections and DDGI, 3 frames.
    H = 1024
    rcfg = RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256)
    cfg = PipelineConfig(width=width, height=H, raster=rcfg, shadow_map_size=S)
    kw = dict(ssao=True, rt_shadows=True, rt_reflections=True, ddgi=True, taa=False)
    job = BandJob(functools.partial(sb.bench_scene, "rt_soft", cfg), cfg, 3, kw)
    scene, cam = job.scene()
    ref = Renderer(scene, cam, cfg, device=dev, **kw)
    ref_ldr = ref.render_frames(job.frames).cpu().numpy()
    name = f"sharded rt_soft+ddgi+ssao+bloom n=4 {width}x{H} (gloo)"
    res = run_bands(sb.rank_run, 4, "gloo", ["cuda"] * 4, job, iters)
    ranks = band_records(res, name, card)
    band_h = band_config(cfg, 4).height
    for r in ranks:
        if r["raster_launches_by_shape"] != {f"{band_h}x{width}": job.frames}:
            raise AssertionError(f"{name}: rank {r['rank']} rastered "
                                 f"{r['raster_launches_by_shape']}")
        if not r["cuts"] or "DDGI.irradiance" not in r["replicated"]:
            raise AssertionError(f"{name}: no replicated stage was hashed")
    frame_agreement(name, res["ldr"], ref_ldr, card)
    out["raster_launches"]["camera_band4"] = sum(r["raster_launches"] for r in ranks)
    for t in ranks[-1]["traces_measured"]:
        t["name"] = f"band n=4 rank 3 {t['trace']}"
        print(tb.describe(t, card), flush=True)
        out["traces"].append((sum(r["trace_launches_by_label"].get(t["trace"], 0)
                                  for r in ranks), t))
    cases = rb.forward_raster_inputs(ref.scene_arrays, cam.state(0, dev), ref.cfg.scene, width,
                                     H, S, rcfg)
    cam_setup = cases["camera"][0]
    del cases
    compare_and_time("camera_band4", f"camera band {width}x{band_h} at y_offset {band_h}, tile "
                     "8x128 (n=4)", 5, cam_setup,
                     raster.bin_triangles(cam_setup, width, band_h, rcfg, y_offset=band_h),
                     width, band_h, False, rcfg=rcfg, y_offset=band_h)
    del ref, cam_setup
    print(f"phase 20: the ranks share one card over gloo (host-staged collectives): a "
          f"correctness run, not a scaling measurement; phase 20 took "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out


# Phase 21: the bench's frames a run (warm-up, timed) and the reduced rates.
SLICE16_FRAMES = (2, 4)
# Phase 22: the single-card frame kinds (phase 5's forward slice and the
# bench's Renderer kinds), each captured against eager.
CAPTURE_KINDS = ("forward_slice", "forward", "full_post", "bindless", "test_spot",
                 "forward_upscaled", "rt", "rt_soft", "stress", "meshlet", "ddgi", "showcase",
                 "flagship", "helmet", "translucent")
HALF_RATE_KINDS = ("rt", "rt_soft")
DDGI_RATE_KINDS = ("ddgi", "showcase")


def run_slice16(dev, card: str, compare, warmup: int = SLICE16_FRAMES[0],
                iters: int = SLICE16_FRAMES[1]) -> dict:
    """Phase 21 (see the module docstring). Returns {"traces": [(the
    half-rate run's launches by label, measured trace)]}."""
    from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda
    from arkoserenderer_torch.ops.raster_cuda import rasterize_tiles_cuda
    from arkoserenderer_torch.tools import bench
    from arkoserenderer_torch.tools import raster_bench as rb
    from arkoserenderer_torch.tools import trace_bench as tb

    t_phase = time.perf_counter()
    out = {"traces": []}

    def run(name, rates, per_frame):
        """One kind at ``rates`` through the bench, its launches and counted
        frames checked; then one more frame's rasters (and traces) captured,
        each raster bit for bit against the plain raster."""
        rasterize_tiles_cuda.launches_by_shape.clear()
        res, renderer = bench.run_config(name, warmup=warmup, iters=iters, rates=rates)
        by_shape = dict(rasterize_tiles_cuda.launches_by_shape)
        n = res["frames"]
        tag = f"{name} {', '.join(f'{k}={v}' for k, v in rates.items())}"
        if by_shape != bench.expected_launches_by_shape(renderer, n):
            raise AssertionError(f"{tag}: raster launches {by_shape} in {n} frames")
        if (res["trace_launches"] != res["trace_launches_expected"]
                or sum(res["trace_launches"].values()) != per_frame * n):
            raise AssertionError(f"{tag}: traversal launches {res['trace_launches']} in {n} "
                                 f"frames, expected {res['trace_launches_expected']}")
        if any(res["rates"][k] != v for k, v in rates.items()):
            raise AssertionError(f"{tag}: ran at {res['rates']}")
        checks = res["frame_checks"] + [{"ldr_finite": res["ldr_finite"],
                                         "coverage": res["coverage"]}]
        if not all(c["ldr_finite"] and c["coverage"] > 0.0 for c in checks):
            raise AssertionError(f"{tag}: a counted frame is not finite or covers nothing: "
                                 f"{checks}")
        print(f"{tag} {res['width']}x{res['height']}: {n} frames, median "
              f"{res['ms_per_frame']:.4f} ms/frame over {iters} (CUDA events; min "
              f"{res['ms_min']:.4f}, max {res['ms_max']:.4f}; host wall clock "
              f"{res['wall_ms_per_frame']:.4f}), coverage {res['coverage']:.4f}, rasters "
              f"{by_shape}, traces {res['trace_launches']}, peak memory "
              f"{res['peak_memory_gib']:.3f} GiB [{card}]", flush=True)
        print_frame_table(res, card)
        ldr = renderer.state["LDR"].clone()
        rasters, cases = rb.capture_rasters(lambda: tb.kind_traces(renderer, f"{tag}:"))
        one, two = (bench.expected_launches_by_shape(renderer, k) for k in (1, 2))
        if sorted(rasters) != sorted(k for k in two if two[k] > one[k]):
            raise AssertionError(f"{tag}: one more frame rastered {sorted(rasters)}")
        for (h, w, depth_only), (setup, bins, *_) in sorted(rasters.items()):
            compare(f"{tag} {w}x{h}{' depth-only' if depth_only else ''}", setup, bins, w, h,
                    renderer.cfg.raster, depth_only)
        del renderer
        return res, ldr, cases

    # (a) half-rate ray tracing: quarter the rays of RTShadow and RTReflections.
    for name in HALF_RATE_KINDS:
        full, full_ldr, _ = run(name, {"rt_scale": 1}, 5)
        half, half_ldr, cases = run(name, {"rt_scale": 2}, 5)
        diff = (half_ldr - full_ldr).abs()
        mean, off = diff.mean().item(), (diff.amax(dim=-1) > 0.1).float().mean().item()
        print(f"{name} rt_scale=2 against rt_scale=1 after the same {full['frames']} frames: "
              f"LDR mean abs diff {mean:.6f} (< 0.02), {off:.4%} of pixels off by > 0.1 "
              f"(< 6 %); ms/frame {half['ms_per_frame']:.4f} against {full['ms_per_frame']:.4f}; "
              f"RTShadow {half['eager_pass_ms']['RTShadow']:.4f} against "
              f"{full['eager_pass_ms']['RTShadow']:.4f}, RTReflections "
              f"{half['eager_pass_ms']['RTReflections']:.4f} against "
              f"{full['eager_pass_ms']['RTReflections']:.4f} ms [{card}]", flush=True)
        if not (mean < 0.02 and off < 0.06):
            raise AssertionError(f"{name}: the half-rate frame is off the full-rate one "
                                 f"(mean {mean}, {off:.4%} of pixels off by > 0.1)")
        got = sorted((c["trace"], c["origins"].shape[0]) for c in cases)
        quarter = (1080 // 2) * (1920 // 2)
        if [t for t, _ in got] != sorted(half["trace_launches_expected"]) or any(
                r != quarter for t, r in got if t in ("sun mask", "reflection")):
            raise AssertionError(f"a half-rate {name} frame traced {got}, expected the sun "
                                 f"mask and reflections at {quarter} rays")
        for c in cases:
            c["label"] = f"{name} rt_scale=2 {c['trace']}"
            t = tb.measure(c["bvh"], c)
            print(tb.describe(t, card), flush=True)
            out["traces"].append((half["trace_launches"], t))

    # (b) DDGI sampled at a quarter of the pixels in LightingCompose.
    for name in DDGI_RATE_KINDS:
        per_frame = 2 if name == "ddgi" else 5
        full, _, _ = run(name, {"ddgi_sample_scale": 1}, per_frame)
        half, _, _ = run(name, {"ddgi_sample_scale": 2}, per_frame)
        print(f"{name} ddgi_sample_scale=2: LightingCompose "
              f"{half['eager_pass_ms']['LightingCompose']:.4f} ms against "
              f"{full['eager_pass_ms']['LightingCompose']:.4f} at 1; ms/frame "
              f"{half['ms_per_frame']:.4f} against {full['ms_per_frame']:.4f} [{card}]",
              flush=True)

    # (c) the sky's env map fetched at half rate.
    full, _, _ = run("forward", {"sky_fetch_scale": 1}, 0)
    half, _, _ = run("forward", {"sky_fetch_scale": 2}, 0)
    print(f"forward sky_fetch_scale=2: SkyView {half['eager_pass_ms']['SkyView']:.4f} ms against "
          f"{full['eager_pass_ms']['SkyView']:.4f} at 1; ms/frame {half['ms_per_frame']:.4f} "
          f"against "
          f"{full['ms_per_frame']:.4f}; phase 21 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return out


CAPTURE_FRAMES, CAPTURE_TIMED_FROM, CAPTURE_PROFILED = 10, 4, 1
CHAIN_BOUND = 0.05  # the per-pass chain's sum against the whole-frame graph's ms


def restart(renderer, camera_position) -> None:
    """``renderer`` back at its first frame: a fresh persistent state, frame
    index 0, time 0, the camera at ``camera_position`` with no previous
    frame (its captured graphs are kept)."""
    renderer.state = renderer.pipeline.initial_state()
    renderer.frame_index = 0
    renderer.time = 0.0
    renderer.camera.position = camera_position.copy()
    renderer.camera._prev_view = renderer.camera._prev_proj = None


def capture_run(renderer, camera_position, move, eager: bool, frames: int | None = None,
                chain: bool = False) -> dict:
    """``frames`` (CAPTURE_FRAMES) frames of ``renderer`` from its first
    (``restart``), captured or ``eager``, the camera moved by ``move``: each
    frame's ms (CUDA events), the host wall ms a frame over the frames from
    CAPTURE_TIMED_FROM (the synchronised clock), the kernels' launches by
    shape and label, peak memory, and copies of the display image and of
    every persistent tensor. With ``chain`` each frame replays the captured
    frame's chain of per-pass graphs: "pass_ms" holds each pass's median
    over the timed frames."""
    import contextlib

    from arkoserenderer_torch.rendering.capture import launch_counts, set_launch_counts
    from arkoserenderer_torch.rendering.pipeline import eager_frames

    frames = frames or CAPTURE_FRAMES
    restart(renderer, camera_position)
    set_launch_counts((0, {}, 0, {}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, passes = [], []
    with eager_frames() if eager else contextlib.nullcontext():
        for f in range(frames):
            if f == CAPTURE_TIMED_FROM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if move is not None:
                move(f)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            pass_events = [] if chain else None
            start.record()
            out = renderer.render_frame(pass_events=pass_events)
            end.record()
            events.append((start, end))
            passes.append(pass_events)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (frames - CAPTURE_TIMED_FROM)
    counts = launch_counts()
    frame_ms = [s.elapsed_time(e) for s, e in events]
    keep = {"display": out.clone()}
    for k in renderer.pipeline.registry.persistent_names:
        v = renderer.state.get(k)
        keep[k] = v.clone() if isinstance(v, torch.Tensor) else v
    per_pass = {}
    for pass_events in passes[CAPTURE_TIMED_FROM:] if chain else ():
        for name, s, e in pass_events:
            per_pass.setdefault(name, []).append(s.elapsed_time(e))
    return {"ms": float(np.median(frame_ms[CAPTURE_TIMED_FROM:])), "frame_ms": frame_ms,
            "wall_ms": wall, "rasters": dict(counts[1]), "traces": dict(counts[3]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "keep": keep,
            "pass_ms": {k: float(np.median(v)) for k, v in per_pass.items()}}


def kernel_ms(step, n: int = CAPTURE_PROFILED) -> float:
    """The card's kernel time a ``step()`` over ``n`` steps after one more:
    torch.profiler's CUDA activity alone (no op tracing on the host). Over
    an unprofiled step's ms it is the busy share."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernel_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return kernel_us / 1e3 / n


def frame_kernel_ms(renderer, move) -> float:
    """``kernel_ms`` of CAPTURE_PROFILED more captured frames of
    ``renderer``."""

    def step():
        if move is not None:
            move(renderer.frame_index)
        renderer.render_frame()

    return kernel_ms(step)


def span(run: dict) -> str:
    """The min-max of a ``capture_run``'s timed frames, ms."""
    timed = run["frame_ms"][CAPTURE_TIMED_FROM:]
    return f"{min(timed):.4f}-{max(timed):.4f}"


def capture_agreement(name: str, other: dict, ref: dict, what: str = "captured") -> None:
    """Hold a run's display image and persistent state (``other``, the
    captured run or the per-pass chain) to ``ref``'s bit for bit."""
    for k, want in ref["keep"].items():
        got = other["keep"][k]
        same = torch.equal(got, want) if isinstance(want, torch.Tensor) else got == want
        if not same:
            diff = ((got.double() - want.double()).abs().max().item()
                    if isinstance(want, torch.Tensor) else f"{got} against {want}")
            raise AssertionError(f"{name}: {what} {k} differs: {diff}")


def run_slice17(dev, card: str, kinds=None) -> dict:
    """Phase 22 (see the module docstring). Returns {kind: its numbers}."""
    import gc

    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.tools import bench

    t_phase = time.perf_counter()
    out = {}
    for name in kinds or CAPTURE_KINDS:
        t_kind = time.perf_counter()
        if name == "forward_slice":  # phase 5's frame: no TAA, no Bloom
            scene, camera, cfg, kw = bench.build_scene("forward")
            kw = dict(kw, taa=False, bloom=False)
        else:
            scene, camera, cfg, kw = bench.build_scene(name)
        renderer = Renderer(scene, camera, cfg, device=dev, **kw)
        base = np.array(renderer.camera.position, np.float32)
        animated = name in bench.CONFIGS and bench.CONFIGS[name][0] in bench.ANIMATED
        move = None if animated else bench.camera_mover(renderer)
        blockers = renderer.pipeline.capture_blockers
        mode = "captured" if not blockers else "eager: " + ", ".join(
            f"{what} ({why})" for what, why in blockers)
        e1 = capture_run(renderer, base, move, eager=True)
        c = capture_run(renderer, base, move, eager=False)
        ch = capture_run(renderer, base, move, eager=False, chain=True)
        want_r = {k: v for k, v in bench.expected_launches_by_shape(
            renderer, CAPTURE_FRAMES).items()}
        want_t = bench.expected_trace_launches_by_label(renderer, CAPTURE_FRAMES)
        for tag, run in (("eager", e1), ("captured", c), ("per-pass chain", ch)):
            if run["rasters"] != want_r or run["traces"] != want_t:
                raise AssertionError(f"{name} {tag}: rasters {run['rasters']} (expected "
                                     f"{want_r}), traces {run['traces']} (expected {want_t}) "
                                     f"in {CAPTURE_FRAMES} frames")
        capture_agreement(name, c, e1)
        if not bool(torch.isfinite(c["keep"]["display"]).all()):
            raise AssertionError(f"{name}: the captured display image is not finite")
        # The chain of per-pass graphs: the whole-frame graph's outputs bit
        # for bit, its passes' sum within 5 % of the whole frame's ms.
        capture_agreement(name, ch, c, "the per-pass chain's")
        chain_sum = sum(ch["pass_ms"].values())
        if not abs(chain_sum - c["ms"]) <= CHAIN_BOUND * c["ms"]:
            raise AssertionError(f"{name}: the per-pass chain's passes sum to {chain_sum} ms "
                                 f"against the whole-frame graph's {c['ms']} ms")
        # The eager frame launches the same kernels on the same inputs (its
        # outputs are the captured ones bit for bit), so one profiled captured
        # frame gives the kernel time of both.
        t_prof = time.perf_counter()
        kernels = frame_kernel_ms(renderer, move)
        busy = {"captured": kernels / c["ms"], "eager": kernels / e1["ms"]}
        t_busy = time.perf_counter() - t_prof
        n_state = sum(isinstance(v, torch.Tensor) for v in c["keep"].values()) - 1
        out[name] = {"mode": mode, "captured_ms": c["ms"], "eager_ms": e1["ms"],
                     "captured_wall_ms": c["wall_ms"], "eager_wall_ms": e1["wall_ms"],
                     "kernel_ms": kernels, "busy_share": busy,
                     "captured_peak_gib": c["peak_gib"], "pass_ms": ch["pass_ms"],
                     "chain_ms": ch["ms"],
                     "eager_peak_gib": e1["peak_gib"],
                     "rasters_per_frame": {str(k): v / CAPTURE_FRAMES for k, v in want_r.items()},
                     "traces_per_frame": {k: v / CAPTURE_FRAMES for k, v in want_t.items()}}
        print(f"phase 22 {name} {renderer.cfg.width}x{renderer.cfg.height}: {mode}; "
              f"{CAPTURE_FRAMES} frames from frame 0, eager then captured: display image "
              f"and {n_state} persistent tensors bit for bit; launches as expected in each run "
              f"(rasters {want_r}, traces {want_t}); ms/frame (median of frames "
              f"{CAPTURE_TIMED_FROM}-{CAPTURE_FRAMES - 1}, CUDA events; min-max) captured "
              f"{c['ms']:.4f} ({span(c)}), eager {e1['ms']:.4f} ({span(e1)}); host wall "
              f"ms/frame captured {c['wall_ms']:.4f}, eager {e1['wall_ms']:.4f}; "
              f"kernel ms/frame ({CAPTURE_PROFILED} profiled captured frame; the eager "
              f"frame's kernels are the same) {kernels:.4f}, busy share (kernels over the "
              f"unprofiled median) captured {busy['captured']:.3f}, eager "
              f"{busy['eager']:.3f}; peak memory captured "
              f"{c['peak_gib']:.3f} GiB (graph pool included), eager {e1['peak_gib']:.3f} GiB; "
              f"{time.perf_counter() - t_kind:.1f} s, of which profiling {t_busy:.1f} s "
              f"[{card}]", flush=True)
        print(f"phase 22 {name}: the chain of per-pass graphs, its display image and persistent "
              f"state bit for bit as the whole-frame graph's; its passes sum to "
              f"{chain_sum:.4f} ms against the whole frame's {c['ms']:.4f} ms "
              f"({chain_sum / c['ms'] - 1:+.2%}; the chain's frame {ch['ms']:.4f}); per-pass "
              f"median ms of frames {CAPTURE_TIMED_FROM}-{CAPTURE_FRAMES - 1} [{card}]: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ch["pass_ms"].items()), flush=True)
        del renderer, e1, c, ch
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 22 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out


# Phase 23: samples a path-tracer run, frames a still or panning run, the
# camera's pan a frame (m), and the reference-mode sorted frame's CPU size.
SLICE18_SAMPLES, SLICE18_FRAMES, PAN_M, SORTED_CPU_SIZE = 16, 8, 0.3, 128
STREAM_TICK_BYTES = 320 << 10  # the streamed spheres' 1.55 MB over five ticks
HISTORY_PASSES = ("RTShadow", "RTReflections", "TemporalUpscale")


def run_slice18(dev, card: str, small: bool = False) -> dict:
    """Phase 23 (see the module docstring). Returns its numbers."""
    import contextlib
    import dataclasses
    import gc

    from arkoserenderer_torch.assets.procedural import build_test_scene
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.pathtracer import PathTracer
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.capture import launch_counts, set_launch_counts
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig, eager_frames
    from arkoserenderer_torch.rendering.streaming import LOADED, StreamingManager
    from arkoserenderer_torch.scene.scene import write_rows
    from arkoserenderer_torch.tools import bench

    t_phase = time.perf_counter()
    out = {}
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)

    # (a) the path tracer's captured sample against the eager one.
    tracer = bench.build_pathtracer(small, dev)
    W, H = tracer.width, tracer.height
    want = bench.expected_trace_launches_by_label(tracer, SLICE18_SAMPLES)

    def samples(eager: bool) -> dict:
        tracer.reset()
        set_launch_counts((0, {}, 0, {}))
        run = bench.time_samples(tracer, SLICE18_SAMPLES, eager)
        run.update(accum=tracer.accum.clone(), ldr=tracer.ldr().clone(),
                   traces=dict(launch_counts()[3]))
        if run["traces"] != want or tracer.sample_count != SLICE18_SAMPLES:
            raise AssertionError(f"pathtraced {'eager' if eager else 'captured'}: traces "
                                 f"{run['traces']} against {want}")
        return run

    eager = samples(True)
    captured = samples(False)
    if tracer._graph is None or not (torch.equal(captured["accum"], eager["accum"])
                                     and torch.equal(captured["ldr"], eager["ldr"])):
        raise AssertionError("pathtraced: the captured samples differ from the eager ones")
    if not (bool(torch.isfinite(captured["ldr"]).all()) and captured["ldr"].mean() > 0):
        raise AssertionError("pathtraced: the captured LDR is not finite, or black")
    k_ms = kernel_ms(lambda: tracer.render_sample(1))
    turns = bench.sample_turns(tracer, SLICE18_SAMPLES // 2)
    accum_ptr = tracer.accum.data_ptr()
    base = tracer.camera.position.copy()
    tracer.camera.position = base + np.array([0.2, 0.0, 0.0], np.float32)
    moved = tracer.render_sample(2).clone()
    count_moved = tracer.sample_count
    tracer.reset()
    with eager_frames():
        moved_eager = tracer.render_sample(2).clone()
    ckpt = out_dir / "pathtracer.npz"
    tracer.save_checkpoint(str(ckpt))
    on = tracer.render_sample(2).clone()
    tracer.load_checkpoint(str(ckpt))
    again = tracer.render_sample(2).clone()
    if not (count_moved == 2 and torch.equal(moved, moved_eager) and torch.equal(on, again)
            and tracer.accum.data_ptr() == accum_ptr):
        raise AssertionError("pathtraced: the reset on a camera move or the checkpoint round "
                             "trip differs under capture")
    tracer.camera.position = base
    busy = {"captured": k_ms / captured["ms"], "eager": k_ms / eager["ms"]}
    out["pathtraced"] = {"captured_ms": captured["ms"], "eager_ms": eager["ms"],
                         "captured_wall_ms": captured["wall_ms"], "eager_wall_ms": eager["wall_ms"],
                         "kernel_ms": k_ms, "busy_share": busy, "turns": turns,
                         "captured_peak_gib": captured["peak_gib"],
                         "eager_peak_gib": eager["peak_gib"]}
    print(f"phase 23 (a) pathtraced {W}x{H}, {tracer.max_bounces} bounces: {SLICE18_SAMPLES} "
          f"samples eager then captured (a CUDA graph of one sample, replayed), the "
          f"accumulation and LDR bit for bit, traces {want} in each; ms/sample (median, CUDA "
          f"events) captured {captured['ms']:.4f}, eager {eager['ms']:.4f}; host wall "
          f"ms/sample captured {captured['wall_ms']:.4f}, eager {eager['wall_ms']:.4f}; kernel "
          f"ms/sample {k_ms:.4f} (one profiled captured sample), busy share captured "
          f"{busy['captured']:.3f}, eager {busy['eager']:.3f}; in turns (8 a block, E C C E) "
          f"captured {turns['captured_ms'][0]:.4f} / {turns['captured_ms'][1]:.4f}, eager "
          f"{turns['eager_ms'][0]:.4f} / {turns['eager_ms'][1]:.4f}; peak memory captured "
          f"{captured['peak_gib']:.3f} GiB (the graph's pool and its capture included), eager "
          f"{eager['peak_gib']:.3f} GiB; the reset on a camera move and a checkpoint round "
          f"trip bit for bit under capture, the accumulation's storage kept [{card}]",
          flush=True)
    del tracer, eager, captured
    g_scene, g_cam = build_test_scene(viewport=(256, 256), n_spheres=1)
    g_tracer = PathTracer(g_scene, g_cam, 256, 256, max_bounces=2, seed=7, device=dev)
    g_tracer.render_sample(4)
    if not (g_tracer.captured and g_tracer._graph is not None):
        raise AssertionError("the pathtraced golden did not run through the captured sample")
    check_golden("pathtraced", g_tracer.ldr())
    del g_tracer

    # (c) streaming into the rt scene with a tick between replays of the
    # captured frame, against eager streaming and against blocking writes.
    class BlockingManager(StreamingManager):
        def _write(self, pool, offset, rows):  # blocking copies, no staging chunk
            write_rows(pool, offset, rows)

    def stream(mode: str) -> dict:
        """A frame loop that ticks, then renders, never waiting on the card:
        a tick runs while the frame before it is in flight."""
        scene, cam, cfg, kw = bench.build_scene("rt", small)
        r = Renderer(scene, cam, cfg, device=dev, **kw)
        seg, worlds = stream_worlds(scene)
        r.render_frame()
        ptrs = tensor_pointers(r.scene_arrays)
        mgr = (BlockingManager if mode == "blocking" else StreamingManager)(
            scene, budget_bytes=STREAM_TICK_BYTES)
        tickets = [mgr.enqueue_instance(seg, w) for w in worlds]
        frames, tick_ms, events, loaded_at = [], [], [], None
        torch.cuda.synchronize()
        with eager_frames() if mode == "eager" else contextlib.nullcontext():
            for f in range(2 * STREAM_FRAMES):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if f < STREAM_FRAMES:
                    t0 = time.perf_counter()
                    r.scene_arrays = mgr.tick(r.scene_arrays)
                    tick_ms.append(((time.perf_counter() - t0) * 1e3,
                                    mgr.bytes_uploaded_last_tick))
                    if loaded_at is None and all(t.state == LOADED for t in tickets):
                        loaded_at = f + 1
                frames.append(r.render_frame().clone())
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
        frame_ms = [a.elapsed_time(b) for a, b in events]
        if loaded_at is None or tensor_pointers(r.scene_arrays) != ptrs:
            raise AssertionError(f"streaming {mode}: loaded after {loaded_at}, pool storage "
                                 f"kept {tensor_pointers(r.scene_arrays) == ptrs}")
        busy_ticks = [ms for ms, b in tick_ms if b > 0]
        return {"frames": frames, "tick_ms": float(np.median(busy_ticks)),
                "first_tick_ms": busy_ticks[0], "ticks": tick_ms,
                "with_ticks_ms": float(np.median(frame_ms[1:STREAM_FRAMES])),
                "without_ms": float(np.median(frame_ms[STREAM_FRAMES + 1:])),
                "loaded_at": loaded_at, "n": len(worlds), "captured": r.pipeline.captured}

    runs = {mode: stream(mode) for mode in ("captured", "eager", "blocking")}
    for mode in ("eager", "blocking"):
        for f, (a, b) in enumerate(zip(runs["captured"]["frames"], runs[mode]["frames"])):
            if not torch.equal(a, b):
                raise AssertionError(f"streamed rt frame {f}: captured with staged ticks "
                                     f"differs from {mode} streaming")
    c_run, b_run = runs["captured"], runs["blocking"]
    out["streaming"] = {m: {k: v for k, v in r_.items() if k != "frames"}
                        for m, r_ in runs.items()}
    print(f"phase 23 (c) streaming {c_run['n']} spheres into the rt scene {W}x{H} "
          f"({STREAM_TICK_BYTES // 1024} KiB a tick, LOADED after {c_run['loaded_at']} ticks) "
          f"with a tick between replays of the captured frame, the host never waiting on the "
          f"card: all {2 * STREAM_FRAMES} frames bit for bit as eager streaming's and as "
          f"blocking writes' (no staging), every pool tensor kept its storage; host ms "
          f"of a tick (median of the ticks that wrote; the first) staged "
          f"{c_run['tick_ms']:.4f} ({c_run['first_tick_ms']:.4f}), blocking "
          f"{b_run['tick_ms']:.4f} ({b_run['first_tick_ms']:.4f}); ms/frame (CUDA events "
          f"around tick + frame, median) captured with ticks {c_run['with_ticks_ms']:.4f}, "
          f"without {c_run['without_ms']:.4f}; blocking ticks {b_run['with_ticks_ms']:.4f}; "
          f"eager streaming {runs['eager']['with_ticks_ms']:.4f} [{card}]", flush=True)
    del runs, c_run, b_run
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the history branches: a still camera (every motion within a pixel:
    # the nine-shift fetch) and a pan (the gather), captured against eager.
    for name in ("rt_soft", "forward_upscaled"):
        scene, camera, cfg, kw = bench.build_scene(name, small)
        renderer = Renderer(scene, camera, cfg, device=dev, **kw)
        start = np.array(renderer.camera.position, np.float32)

        def pan(f, renderer=renderer, start=start):
            renderer.camera.position = start + np.array([PAN_M * f, 0.0, 0.0], np.float32)

        for label, move in (("still", None), ("pan", pan)):
            e1, c = (capture_run(renderer, start, move, eager, SLICE18_FRAMES)
                     for eager in (True, False))
            capture_agreement(f"{name} {label}", c, e1)
            speed = renderer.state["SceneVelocity"].abs().max().item()
            ch = capture_run(renderer, start, move, False, SLICE18_FRAMES, chain=True)
            capture_agreement(f"{name} {label}", ch, c, "the per-pass chain's")
            if (speed <= 1.0) != (label == "still"):
                raise AssertionError(f"{name} {label}: largest motion {speed} px")
            out[f"{name} {label}"] = {"captured_ms": c["ms"], "eager_ms": e1["ms"],
                                      "pass_ms": ch["pass_ms"], "speed_px": speed}
            print(f"phase 23 (d) {name} {renderer.cfg.width}x{renderer.cfg.height} {label} "
                  f"(largest motion component {speed:.4f} "
                  f"render px: the {'shift' if label == 'still' else 'gather'} branch): "
                  f"{SLICE18_FRAMES} frames captured bit for bit as eager; "
                  f"ms/frame captured {c['ms']:.4f}, eager {e1['ms']:.4f}; per-pass graphs "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ch["pass_ms"].items()
                              if k in HISTORY_PASSES) + f" ms [{card}]", flush=True)
        del renderer, e1, c, ch
        gc.collect()
        torch.cuda.empty_cache()

    # (e) the reference shading mode with texture_quality="sorted": the card
    # against the port on the CPU, then its VisibilityShading at 1920x1080.
    size = SORTED_CPU_SIZE
    tile16 = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256)
    imgs = []
    for device in (dev, "cpu"):
        sc, cm = build_test_scene(viewport=(size, size), n_spheres=3)
        c_ = PipelineConfig(width=size, height=size, raster=tile16, shadow_map_size=128,
                            shading_mode="reference", texture_quality="sorted")
        imgs.append(Renderer(sc, cm, c_, device=device, taa=False, bloom=False)
                    .render_frame().cpu().numpy())
    diff = np.abs(imgs[0] - imgs[1])
    off, mean = (diff > 2e-4).mean(), abs(imgs[0].mean() - imgs[1].mean())
    if not (np.isfinite(imgs[0]).all() and off < 0.002 and mean < 1e-5):
        raise AssertionError(f"sorted {size}x{size}: card vs CPU {off:.4%} off by > 2e-4, "
                             f"means {mean}")
    vs = {}
    for quality in ("sorted", "trilinear"):
        sc, cm, c_, kw_ = bench.build_scene("forward", small)
        rr = Renderer(sc, cm, dataclasses.replace(c_, shading_mode="reference",
                                                  texture_quality=quality), device=dev, **kw_)
        res = rr.benchmark(warmup=2, iters=6, before_frame=bench.camera_mover(rr))
        if not bool(torch.isfinite(rr.state["LDR"]).all()):
            raise AssertionError(f"forward reference {quality}: the LDR is not finite")
        vs[quality] = res
        del rr
    out["sorted"] = {q: {"ms": r_["ms_per_frame"],
                         "VisibilityShading": r_["pass_ms"]["VisibilityShading"],
                         "VisibilityShading_eager": r_["eager_pass_ms"]["VisibilityShading"]}
                     for q, r_ in vs.items()}
    print(f"phase 23 (e) shading_mode=reference, texture_quality=sorted: {size}x{size} card "
          f"against the port on the CPU {off:.4%} of values off by > 2e-4 (< 0.2 %), means "
          f"{mean:.2e} apart (< 1e-5); forward {W}x{H} VisibilityShading (captured per-pass "
          f"graphs, eager) sorted {out['sorted']['sorted']['VisibilityShading']:.4f}, "
          f"{out['sorted']['sorted']['VisibilityShading_eager']:.4f} ms against trilinear "
          f"{out['sorted']['trilinear']['VisibilityShading']:.4f}, "
          f"{out['sorted']['trilinear']['VisibilityShading_eager']:.4f} ms; ms/frame "
          f"{vs['sorted']['ms_per_frame']:.4f} against {vs['trilinear']['ms_per_frame']:.4f} "
          f"[{card}]", flush=True)
    print(f"phase 23 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    print(json.dumps({"slice18": out}), flush=True)
    return out


SOUP_TRIS, SOUP_SEED = 4096, 19          # phase 24 (a): the 1080p soup (soup_case)
ORACLE_SIZE, ORACLE_TRIS = (256, 192), 300  # phase 24 (a): against rasterize_numpy
ORACLE_RAYS, ORACLE_SEED, CHUNK = 16384, 23, 4096  # phase 24 (b)
COOK_TEXTURE = 256                         # phase 24 (e): the helmet's max_texture
IES_TEXT = """IESNA:LM-63-2002
[TEST] two planes
TILT=NONE
1 -1 1.5 5 2 1 2 0 0 0
1.0 1.0 0
0 22.5 45 67.5 90
0 90
1000 900 600 200 10
1000 700 500 100 0
"""


def soup_case(rng, n: int, width: int, height: int):
    """n seeded triangles of about 0.2 m in front of the camera, small
    enough at 1920x1080 that every one fits the per-tile lists or the
    global list (nothing dropped): (clip, idx) as ``random_case``'s."""
    from arkoserenderer_torch.core import mathx as mx

    centers = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                        rng.uniform(-10, -4, n)], -1)
    verts = (centers[:, None] + rng.normal(size=(n, 3, 3)) * 0.2).reshape(-1, 3)
    verts = verts.astype(np.float32)
    proj = mx.perspective_reverse_z(np.radians(70.0), width / height, 0.1, 100.0)
    clip = np.concatenate(
        [verts @ proj[:3, :3].T + proj[:3, 3], (verts @ proj[3, :3] + proj[3, 3])[:, None]], -1
    ).astype(np.float32)
    idx = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return torch.from_numpy(clip), torch.from_numpy(idx)


def oracle_rays(scene, n: int, seed: int):
    """n seeded rays into the rt scene: origins over its box, 1-4 m above
    the floor, directions downward-biased, unit length."""
    rng = np.random.default_rng(seed)
    mins, maxs = scene.bounding_box()
    o = np.stack([rng.uniform(mins[0], maxs[0], n), rng.uniform(1.0, 4.0, n),
                  rng.uniform(mins[2], maxs[2], n)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, rng.uniform(0.5, 8.0, n).astype(np.float32)


def against_brute(label: str, hit, ref_t, ref_tri, t_tol: float, tri_share: float,
                  any_hit=None) -> str:
    """tests/test_bvh.py's bounds against trace_rays_brute: the same rays
    hit, ``t`` within ``t_tol`` (rtol and atol) and ``tri`` the same on more
    than ``tri_share`` of the hits; ``any_hit``'s hits equal the oracle's."""
    tri, t = hit.tri.cpu().numpy(), hit.t.cpu().numpy()
    h = ref_tri >= 0
    if not np.array_equal(tri >= 0, h) or h.sum() < 100:
        raise AssertionError(f"{label}: hits differ from brute force on "
                             f"{int(((tri >= 0) != h).sum())} rays ({int(h.sum())} hit)")
    if not np.allclose(t[h], ref_t[h], rtol=t_tol, atol=t_tol):
        raise AssertionError(f"{label}: t off brute force by {np.abs(t[h] - ref_t[h]).max()}")
    same = float((tri[h] == ref_tri[h]).mean())
    if same <= tri_share:
        raise AssertionError(f"{label}: tri equal to brute force on {same:.4%} of hits")
    if any_hit is not None and not np.array_equal(any_hit.hit.cpu().numpy(), h):
        raise AssertionError(f"{label}: any-hit hits differ from brute force")
    return (f"{label}: {len(tri)} rays, {int(h.sum())} hit as brute force, t within "
            f"{np.abs(t[h] - ref_t[h]).max():.3g}, tri equal on {same:.4%}")


def run_slice19(dev, card: str, compare_and_time) -> dict:
    """Phase 24 (see the module docstring). Returns the rasterize row's
    launches and the measured traces with their launches."""
    import dataclasses
    import subprocess
    import tempfile

    from arkoserenderer_torch.assets.baked import load_baked
    from arkoserenderer_torch.assets.procedural import gradient_env_map
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.pathtracer import world_space_vertices
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops import bvh as bvh_ops
    from arkoserenderer_torch.ops import raster
    from arkoserenderer_torch.ops.raster_reference import rasterize_numpy
    from arkoserenderer_torch.ops.rt import shade_hits_simple, trace_shadow_mask
    from arkoserenderer_torch.rendering.capture import launch_counts, set_launch_counts
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_torch.scene.camera import Camera
    from arkoserenderer_torch.scene.lights import DirectionalLight
    from arkoserenderer_torch.tools import bench, cooker
    from arkoserenderer_torch.tools import trace_bench as tb
    from arkoserenderer_torch.utils.imageio import save_png

    t_phase = time.perf_counter()
    out = {"traces": []}

    def counted(fn):
        """fn() with every kernel count set to 0 just before it; returns
        (result, raster launches, traversal launches by label)."""
        set_launch_counts((0, {}, 0, {}))
        res = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        return res, counts[0], dict(counts[3])

    # (a) rasterize: the 1080p soup through the kernel, bit for bit against
    # the plain raster on the same setup and bins, timed as in phase 3.
    W, H = 1920, 1080
    cfg = RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256)
    clip, idx = (x.to(dev) for x in soup_case(np.random.default_rng(SOUP_SEED), SOUP_TRIS, W, H))
    valid = torch.ones(SOUP_TRIS, dtype=torch.bool, device=dev)
    (vis, depth, setup, bins), n_raster, _ = counted(
        lambda: raster.rasterize(clip, idx, valid, width=W, height=H, cfg=cfg))
    if n_raster != 1 or int(bins.overflow) != 0:
        raise AssertionError(f"phase 24 (a): rasterize launched the raster kernel {n_raster} "
                             f"times (expected 1), dropped {int(bins.overflow)} entries")
    pv, pd = raster.rasterize_tiles_plain(setup, bins, W, H, cfg)
    if not (torch.equal(vis, pv) and torch.equal(depth, pd)) or vis.shape != (H, W):
        raise AssertionError("phase 24 (a): rasterize's vis or depth differ from the plain "
                             "raster's on its setup and bins")
    cover = (depth > 0).float().mean().item()
    if not 0.2 < cover < 1.0:
        raise AssertionError(f"phase 24 (a): the soup covers {cover:.4f} of the frame")
    compare_and_time("rasterize", f"rasterize {W}x{H} soup of {SOUP_TRIS} triangles, tile "
                     "8x128", 5, setup, bins, W, H, False, rcfg=cfg)
    out["raster_launches"] = {"rasterize": n_raster}
    w2, h2 = ORACLE_SIZE
    clip, idx = (x.numpy() for x in random_case(np.random.default_rng(SOUP_SEED + 1),
                                                 ORACLE_TRIS, False, w2, h2))
    valid = np.ones(ORACLE_TRIS, bool)
    cfg2 = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256)
    (v2, d2, _, b2), n2, _ = counted(lambda: raster.rasterize(
        *(torch.from_numpy(x).to(dev) for x in (clip, idx, valid)), width=w2, height=h2,
        cfg=cfg2, cull_backfaces=False))
    ref_vis, ref_depth = rasterize_numpy(clip, idx, valid, w2, h2, cull_backfaces=False)
    v2, d2 = v2.cpu().numpy(), d2.cpu().numpy()
    ids_off = float((v2 != ref_vis).mean())
    if not (n2 == 1 and int(b2.overflow) == 0 and np.array_equal(v2 == -1, ref_vis == -1)
            and ids_off < 0.001 and np.allclose(d2, ref_depth, atol=1e-5)):
        raise AssertionError(f"phase 24 (a): rasterize {w2}x{h2} against rasterize_numpy: "
                             f"{ids_off:.4%} ids off, depth off by "
                             f"{np.abs(d2 - ref_depth).max()}, overflow {int(b2.overflow)}")
    print(f"phase 24 (a) rasterize {W}x{H}: one kernel launch, vis and depth bit for bit "
          f"against the plain raster, coverage {cover:.4f}, {int(bins.global_count)} global, "
          f"none dropped; {w2}x{h2}, {ORACLE_TRIS} two-sided "
          f"triangles against rasterize_numpy: coverage equal, {ids_off:.4%} of ids off "
          f"(< 0.1 %), depth within {np.abs(d2 - ref_depth).max():.3g} (1e-5)", flush=True)

    # (b) the traversal against the oracles on the rt scene.
    scene, _, _, _ = bench.build_scene("rt")
    arrays = scene.build(dev, with_bvh=True)
    wv = world_space_vertices(arrays).astype(np.float32)
    tris, tri_valid = arrays.indices.cpu().numpy(), arrays.tri_valid.cpu().numpy()
    o_np, d_np, tm_np = oracle_rays(scene, ORACLE_RAYS, ORACLE_SEED)
    o, d, tm = (torch.from_numpy(x).to(dev) for x in (o_np, d_np, tm_np))
    ref_t, ref_tri = bvh_ops.trace_rays_brute(wv, tris, tri_valid, o_np, d_np)
    lines = []
    hits = {}
    for any_hit in (False, True):
        name = f"phase24 {'any-hit' if any_hit else 'closest'}"
        hits[any_hit], _, by_label = counted(lambda: bvh_ops.trace_rays(
            arrays.bvh, o, d, any_hit=any_hit, label=name))
        case = dict(label=name, origins=o, directions=d, t_max=1e30, any_hit=any_hit)
        out["traces"].append((by_label.get(name, 0), tb.measure(arrays.bvh, case)))
    lines.append(against_brute("kernel closest-hit", hits[False], ref_t, ref_tri, 1e-3, 0.99,
                               any_hit=hits[True]))
    binary = dataclasses.replace(arrays.bvh, **{f: None for f in (
        "wide_meta", "wide_src", "wide_cbounds", "wide_root_blas", "wide_rec", "quad_rec",
        "inst_rec")})
    # Any-hit keeps the first hit its walk order meets: only ``hit`` is the
    # same function of the rays in both walks.
    for any_hit in (False, True):
        (bh, n_r, by_label) = counted(lambda: bvh_ops.trace_rays(binary, o, d, any_hit=any_hit))
        kh = hits[any_hit]
        same = torch.equal(bh.hit, kh.hit) and (any_hit or (
            torch.equal(bh.tri, kh.tri) and torch.allclose(bh.t, kh.t, rtol=1e-5, atol=1e-5)))
        if n_r or by_label or not same:
            raise AssertionError(f"phase 24 (b): the binary walk (any_hit={any_hit}) differs "
                                 f"from the kernel on {int((bh.tri != kh.tri).sum())} tris, "
                                 f"{int((bh.hit != kh.hit).sum())} hits, or launched a kernel")
    lines.append("binary two-level walk on the card (wide_meta None): closest-hit hit and tri "
                 "equal to the kernel's and t within 1e-5, any-hit hit equal; no kernel launched")
    flat = bvh_ops.build_bvh(wv, tris, tri_valid, device=dev)
    fh, n_r, by_label = counted(lambda: bvh_ops.trace_rays(flat, o, d))
    if n_r or by_label:
        raise AssertionError("phase 24 (b): the flat walk launched a kernel")
    lines.append(against_brute("flat walk on the card", fh, ref_t, ref_tri, 1e-4, 0.995))
    whole = bvh_ops.trace_rays(arrays.bvh, o, d, t_max=tm, any_hit=True)
    chunked, _, by_label = counted(lambda: bvh_ops.trace_rays(
        arrays.bvh, o, d, t_max=tm, any_hit=True, chunk_size=CHUNK, label="phase24 chunked"))
    if by_label.get("phase24 chunked") != ORACLE_RAYS // CHUNK or any(
            not torch.equal(x, y) for x, y in zip(chunked, whole)):
        raise AssertionError(f"phase 24 (b): the chunked trace ({by_label}) differs from the "
                             "unchunked one")
    lines.append(f"chunk_size={CHUNK} with per-ray t_max: {ORACLE_RAYS // CHUNK} launches, "
                 "equal to the unchunked trace bit for bit")
    for line in lines:
        print(f"phase 24 (b) {line}", flush=True)
    for _, t in out["traces"]:
        print(tb.describe(t, card), flush=True)

    # (c) a scene built without a BVH: every ray misses, every receiver lit.
    bare = scene.build(dev)
    miss, n_r, by_label = counted(lambda: bvh_ops.trace_rays(bare.bvh, o, d, t_max=1e4))
    lit = trace_shadow_mask(bare, o, -arrays.lights.sun_direction,
                            torch.ones(ORACLE_RAYS, dtype=torch.bool, device=dev))
    if not (isinstance(bare.bvh, bvh_ops.FlatBVH) and not bool(miss.hit.any())
            and bool((miss.tri == -1).all()) and bool((miss.t == 1e4).all())
            and bool((lit == 1.0).all()) and n_r == 0 and not by_label):
        raise AssertionError("phase 24 (c): the no-BVH scene does not miss every ray")
    print("phase 24 (c) no-BVH scene on the card: its placeholder FlatBVH misses every ray "
          "(t = t_max, tri = -1), trace_shadow_mask all lit", flush=True)

    # (d) shade_hits_simple on (b)'s closest hits, its occlusion rays through
    # the kernel, against the same call through the plain walk.
    shade_label = "simple occlusion"
    shaded, _, by_label = counted(lambda: shade_hits_simple(arrays, hits[False], d, 0.5))
    with tb.plain_traces():
        shaded_plain = shade_hits_simple(arrays, hits[False], d, 0.5)
    if by_label.get(shade_label) != 1 or not torch.equal(shaded, shaded_plain) or not bool(
            torch.isfinite(shaded).all()):
        raise AssertionError(f"phase 24 (d): shade_hits_simple ({by_label}) differs from its "
                             "plain-walk twin")
    case = tb.capture_calls(lambda: shade_hits_simple(arrays, hits[False], d, 0.5))[0]
    case["label"] = "phase24 " + shade_label
    out["traces"].append((by_label[shade_label], tb.measure(arrays.bvh, case)))
    print(f"phase 24 (d) shade_hits_simple on {ORACLE_RAYS} hits: one occlusion trace through "
          f"the kernel, equal bit for bit to the plain walk's; mean radiance "
          f"{shaded.mean().item():.4f}", flush=True)
    print(tb.describe(out["traces"][-1][1], card), flush=True)
    del arrays, bare, flat, binary

    # (e) the offline tools, then the cooked helmet on the card.
    helmet = ROOT / "assets" / "sample" / "DamagedHelmet" / "DamagedHelmet.gltf"
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "models").mkdir()
        for f in helmet.parent.glob("DamagedHelmet.*"):
            if f.suffix in (".gltf", ".bin"):
                shutil.copy(f, root / "models" / f.name)
        for f in helmet.parent.glob("*.jpg"):
            shutil.copy(f, root / "models" / f.name)
        rng = np.random.default_rng(29)
        (root / "textures").mkdir()
        for name in ("a", "b"):
            save_png(str(root / "textures" / f"{name}.png"),
                     rng.integers(0, 256, (64, 64, 4), np.uint8))
        (root / "lights").mkdir()
        (root / "lights" / "p.ies").write_text(IES_TEXT)
        (root / "hair").mkdir()
        segs = np.array([2, 3, 1], np.uint16)
        head = b"HAIR" + np.array([3, 9, 1, 2], np.uint32).tobytes() + np.array(
            [0.1, 0.0, 0.5, 0.3, 0.1], np.float32).tobytes()
        (root / "hair" / "h.hair").write_bytes(
            head.ljust(128, b"\0") + segs.tobytes() + rng.normal(size=(9, 3)).astype(
                np.float32).tobytes())
        (root / "misc").mkdir()
        (root / "misc" / "notes.txt").write_text("copied as is\n")
        rules = [("gltf", "models/*.gltf", "baked/{stem}.arkscene.npz",
                  f"max_texture = {COOK_TEXTURE}\n"),
                 ("image", "textures/*.png", "baked/{stem}.mips.npz", ""),
                 ("bc7", "textures/*.png", "baked/{stem}.dds", 'quality = "fast"\n'),
                 ("ies", "lights/*.ies", "baked/{stem}.ies.npz", ""),
                 ("hair", "hair/*.hair", "baked/{stem}.hair.npz", ""),
                 ("copy", "misc/*.txt", "baked/{name}", "")]
        (root / "rules.toml").write_text("".join(
            f'[[rule]]\nname = "{t}"\ntool = "{t}"\ninput = "{i}"\noutput = "{o}"\n{x}\n'
            for t, i, o, x in rules))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "arkoserenderer_torch.tools.cooker",
                              str(root / "rules.toml")], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        cook_s = time.perf_counter() - t0
        built = sorted(Path(p).name for p in re.findall(r"built (\S+)", run.stdout))
        want = sorted(["DamagedHelmet.arkscene.npz", "a.mips.npz", "b.mips.npz", "a.dds",
                       "b.dds", "p.ies.npz", "h.hair.npz", "notes.txt"])
        if run.returncode != 0 or built != want:
            raise AssertionError(f"phase 24 (e): the cooker built {built} (rc "
                                 f"{run.returncode}): {run.stdout[-2000:]}{run.stderr[-2000:]}")
        again = cooker.Cooker(root / "rules.toml").cook()
        save_png(str(root / "textures" / "a.png"), rng.integers(0, 256, (64, 64, 4), np.uint8))
        touched = cooker.Cooker(root / "rules.toml").cook()
        if again["built"] or sorted(Path(p).name for p in touched["built"]) != [
                "a.dds", "a.mips.npz"]:
            raise AssertionError(f"phase 24 (e): rebuilds {again['built']} then "
                                 f"{touched['built']}")
        print(f"phase 24 (e) python -m arkoserenderer_torch.tools.cooker built {len(built)} "
              f"outputs in {cook_s:.1f} s (the helmet at max_texture {COOK_TEXTURE}); a second "
              "run rebuilt nothing; touching a.png rebuilt a.dds and a.mips.npz only",
              flush=True)
        baked = load_baked(root / "baked" / "DamagedHelmet.arkscene.npz",
                           limits=cooker.baking_limits())
    baked.sun = DirectionalLight(direction=np.array([0.35, -1.0, -0.25], np.float32))
    baked.set_env_map(gradient_env_map(32), brightness=8000.0)
    baked.ambient_lx = 6000.0
    cam = Camera(viewport=(512, 512))
    center, radius = baked.bounding_sphere()
    cam.look_at(center + np.array([radius * 1.2, radius * 0.5, radius * 1.2]), center)
    r = Renderer(baked, cam, PipelineConfig(width=512, height=512, shadow_map_size=1024,
                                            raster=RasterConfig(tile_h=8, tile_w=128,
                                                                max_tris_per_tile=512)),
                 device=dev, taa=False, bloom=False)
    img, n_r, _ = counted(lambda: r.render_frame().clone())
    cover = r.state["SceneCoverage"].float().mean().item()
    if not (bool(torch.isfinite(img).all()) and 0.05 < cover < 1.0 and n_r >= 1
            and img.std().item() > 0.01):
        raise AssertionError(f"phase 24 (e): the baked helmet's 512^2 frame: coverage {cover}, "
                             f"{n_r} raster launches")
    print(f"phase 24 (e) the baked helmet (load_baked) at 512x512 on the card: finite, "
          f"coverage {cover:.4f}, {n_r} raster kernel launches", flush=True)
    del r
    print(f"phase 24 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out


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
    t_main = time.perf_counter()
    card = rb.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build ----------------------------------------------------------------
    print(f"[phase 2 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
    print(f"[phase 3 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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

    def compare_and_time(name, label, p_iters, setup, bins, w, h, depth_only,
                         rcfg=full_raster, depth_limit=None, y_offset=0):
        kw = dict(depth_only=depth_only, depth_limit=depth_limit, y_offset=y_offset)
        err = compare(label, setup, bins, w, h, rcfg, **kw)[0]
        device_ms = rb.kernel_ms(lib, setup, bins, w, h, rcfg, depth_only, depth_limit,
                                 y_offset=y_offset)
        k_ms = rb.events_ms(lambda: rasterize_tiles_cuda(setup, bins, w, h, rcfg, **kw),
                            rb.WRAPPER_CALLS[name])
        p_ms = rb.events_ms(lambda: raster.rasterize_tiles_plain(setup, bins, w, h, rcfg, **kw),
                            p_iters)
        before, after = rb.pixel_tests(setup, bins, w, h, rcfg, y_offset=y_offset)
        bound, kind = rb.bound_ms(setup, bins, w, h, depth_only, after,
                                  depth_limit=depth_limit is not None)
        timed[name] = dict(max_abs_err=err, ms=k_ms, device_ms=device_ms, plain_ms=p_ms,
                           bound_ms=bound, bound_by=kind, shape=label)
        counts, px = bins.counts.float(), rcfg.tile_h * rcfg.tile_w
        print(f"{label}: {counts.numel()} tiles, {int(counts.sum())} binned pairs (mean "
              f"{counts.mean().item():.4f}, max {int(counts.max())} a tile), "
              f"{int(bins.global_count)} global; (tile, triangle) pairs walked "
              f"{before // px} before rejection, {after // px} after", flush=True)
        print(f"{label}: kernel {k_ms:.4f} ms (wrapper, CUDA events), {device_ms:.4f} ms "
              f"(device, CUDA graph), plain {p_ms:.4f} ms; pixel tests {before} before "
              f"rejection, {after} after; bound {bound:.4f} ms ({kind}), "
              f"{bound / device_ms:.1%} of the bound on device time, {bound / k_ms:.1%} on "
              f"the wrapper's [{card}]", flush=True)
        return timed[name]

    for name, label, p_iters in (("camera", f"camera {W}x{H}, tile 8x128", 5),
                                 ("sun", f"sun {S}x{S} depth-only", 2)):
        compare_and_time(name, label, p_iters, *cases[name])
    timed["camera"]["max_abs_err"] = max(errs + [timed["camera"]["max_abs_err"]])
    del cases, setup, bins

    # -- 4. golden on the card ----------------------------------------------------
    print(f"[phase 4 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    g_cfg = PipelineConfig(width=256, height=256,
                           raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                           shadow_map_size=256)
    g_scene, g_cam = build_test_scene(viewport=(256, 256))
    check_golden("forward", Renderer(g_scene, g_cam, g_cfg, device=dev, taa=False,
                                     bloom=False).render_frame())

    # -- 5. the slice at full size --------------------------------------------------
    print(f"[phase 5 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
    if launches != r.frame_index + 1:
        raise AssertionError(f"raster kernel launched {launches} times in {r.frame_index} "
                             f"frames, expected {r.frame_index + 1}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"forward slice {W}x{H} shadow {S}: {r.frame_index} frames ({FRAMES} captured, then "
          f"3 eager for the per-pass table), median "
          f"{slice1['ms_per_frame']:.4f} "
          f"ms/frame over the last {FRAMES - WARMUP} (CUDA events), coverage {coverage:.4f}, "
          f"raster launches {launches}, peak memory {peak / 2**30:.3f} GiB [{card}]", flush=True)
    print_frame_table(slice1, card)
    del r

    # -- 6. the full_post golden on the card ----------------------------------------
    print(f"[phase 6 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    g_scene, g_cam = build_test_scene(viewport=(256, 256))
    check_golden("full_post", Renderer(g_scene, g_cam, g_cfg, device=dev, ssao=True,
                                       motion_blur=True).render_frames(3))

    # -- 7. the local-shadow raster --------------------------------------------------
    print(f"[phase 7 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    spot = bench.build_renderer("test_spot", device=dev)
    A = spot.cfg.local_shadow_map_size
    compare_and_time("local", f"local shadow {A}x{A} depth-only", 5,
                     *rb.local_shadow_raster_inputs(spot.scene_arrays, spot.camera.state(0, dev),
                                                    A, full_raster))
    del spot

    # -- 8. and 9. the frame kinds, through the bench ---------------------------------
    print(f"[phase 8 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
                       "rt_soft": 1.0, "translucent": 1.0}
    by_kind = {}
    for name in PHASE8:
        by_kind[name] = run_kind(name)[2]

    # -- 9. the stress, meshlet and forward_upscaled frames ---------------------------
    print(f"[phase 9 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
    print(f"[phase 10 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
    print(f"[phase 11 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
    print(f"[phase 12 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    res, renderer = run_traced_kind("ddgi", 2)
    if res["passes"][:4] != ["Scene", "Geometry", "BVHRefit", "DDGI"] or not (
            "SSSS" in res["eager_pass_ms"] and "BVHRefit" in res["eager_pass_ms"]):
        raise AssertionError(f"ddgi: passes {res['passes']}, timed {list(res['eager_pass_ms'])}")
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
    print(f"[phase 13 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
    print(f"[phase 14 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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
    print(f"[phase 15 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
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

    # -- 16. the showcase app at 1920x1080 ----------------------------------------------
    print(f"[phase 16 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    app = run_app(dev, card, compare_and_time, check_kind_traces)
    kind_traces += app["traces"]

    # -- 17. translucency, the reference shading mode, the app on an .arklvl ----------
    print(f"[phase 17 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    translucency = run_translucency(dev, card, compare_and_time, run_kind)

    # -- 18. hair, streaming, the overlays, geodata and meshviewer ---------------------
    print(f"[phase 18 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    slice13 = run_slice13(dev, card, compare_and_time, check_kind_traces)
    kind_traces += slice13["traces"]

    # -- 19. the live viewer, its systems, physics, hot reload, profiling ----------------
    print(f"[phase 19 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    slice14 = run_slice14(dev, card, compare_and_time)

    # -- 20. pixel-band sharding: banded rasters, halos, gathers ------------------------
    print(f"[phase 20 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    slice15 = run_slice15(dev, card, compare_and_time)

    # -- 21. the reduced-rate paths: half-rate RT, DDGI sampling, the sky fetch ---------
    print(f"[phase 21 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    slice16 = run_slice16(dev, card, compare)

    # -- 22. the captured frame against the eager one, every kind -----------------------
    print(f"[phase 22 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    run_slice17(dev, card)
    print(f"[phase 23 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    run_slice18(dev, card)
    print(f"[phase 24 starts {time.perf_counter() - t_main:.1f} s into the script]", flush=True)
    slice19 = run_slice19(dev, card, compare_and_time)

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

    print(f"phases 1-24 took {time.perf_counter() - t_main:.1f} s", flush=True)
    print(card)
    rows = [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches[name],
        "launches_forward_slice": slice1_launches.get(entries[name][1], 0),
        **timed[name], "library_ms": None,
    } for name in entries]
    rows += [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": app["raster_launches"][name], **timed[name],
        "library_ms": None,
    } for name in ("camera_app", "sun_app")]
    rows += [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": translucency["launches"][name],
        **translucency["timed"][name], "library_ms": None,
    } for name in ("peel", "peel_app")]
    rows += [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches_18, **timed[name], "library_ms": None,
    } for name, launches_18 in slice13["raster_launches"].items()]
    rows += [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches_19, **timed[name], "library_ms": None,
    } for name, launches_19 in slice14["raster_launches"].items()]
    rows += [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches_20, **timed[name], "library_ms": None,
    } for name, launches_20 in slice15["raster_launches"].items()]
    rows += [{
        "name": f"raster_tiles ({name})", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches_24, **timed[name], "library_ms": None,
    } for name, launches_24 in slice19["raster_launches"].items()]

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
    rows += [trace_row(t, launches) for launches, t in slice15["traces"]]
    rows += [trace_row(t, by_label.get(t["trace"], 0)) for by_label, t in slice16["traces"]]
    rows += [trace_row(t, launches) for launches, t in slice19["traces"]]
    if not all(row["launches"] for row in rows):
        raise AssertionError("a kernel of the frames' path was never launched")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
