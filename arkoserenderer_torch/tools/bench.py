"""Frame-time bench of the port's raster frames on the card.

The frame kinds (the reference's ``bench.py`` configs of the same names):

  forward    test scene; visibility-buffer raster + sun shadow + PBR shading +
             Bloom + TAA + tonemap
  full_post  the same + SSAO, Fog, MotionBlur and DepthOfField
  bindless   256 materials over 64 texture chains + MotionBlur + DepthOfField
  test_spot  the test scene with one shadow-casting spot light: its shadow
             map is rastered every frame (LocalShadow) and PCF-sampled

at 1920x1080, raster tile 8x128 with 256 triangles a tile, and an 8192^2 sun
shadow map (``--small``: 256x256, tile 8x16, a 256^2 map, 64 materials over
16 chains). The camera moves every frame, so the motion vectors, TAA's
reprojection and the motion blur do real work.

    python -m arkoserenderer_torch.tools.bench [--config forward,full_post] [--small]
                                               [--warmup 4] [--iters 16] [--profile]

prints the card's name and power limit, then one JSON line per frame kind:
ms/frame (median, min, max of CUDA-event times around each frame, and the
host's wall clock per frame), the median ms of every pass, peak device
memory, the raster kernel's launches, coverage and how far TAA's history
moved in one frame. With ``--profile`` it then runs 4 more frames of each
kind under ``torch.profiler`` and prints a second JSON line: the device's
kernel ms per frame, its busy share of the frame, launches per frame, the
operators and kernels that take the most device time, and each pass's span
on the device. Needs a
GPU; run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from arkoserenderer_torch.assets.procedural import build_bindless_scene, build_test_scene
from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.models.standard import Renderer
from arkoserenderer_torch.ops.raster_cuda import rasterize_tiles_cuda
from arkoserenderer_torch.rendering.pipeline import PipelineConfig
from arkoserenderer_torch.scene.lights import SpotLight
from arkoserenderer_torch.tools.raster_bench import card_line

# name -> (scene kind, pipeline flags, description)
CONFIGS = {
    "forward": ("test", {}, "forward (visbuf raster + shadow + PBR + bloom + TAA + tonemap)"),
    "full_post": ("test", dict(ssao=True, fog=True, motion_blur=True, depth_of_field=True),
                  "full post (TAA + bloom + SSAO + fog + motion blur + DoF)"),
    "bindless": ("bindless", dict(motion_blur=True, depth_of_field=True),
                 "256 materials / 64 textures bindless + TAA + motion blur + DoF"),
    "test_spot": ("test_spot", {}, "forward + one shadow-casting spot light (LocalShadow + PCF)"),
}


def pipeline_config(small: bool = False) -> PipelineConfig:
    if small:
        return PipelineConfig(width=256, height=256, shadow_map_size=256,
                              raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256))
    return PipelineConfig(width=1920, height=1080, shadow_map_size=8192,
                          raster=RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256))


def build_renderer(name: str, small: bool = False, device="cuda",
                   cfg: PipelineConfig | None = None) -> Renderer:
    """The Renderer of frame kind ``name`` at ``pipeline_config(small)``, or
    at ``cfg`` when given (the scene's size still follows ``small``)."""
    kind, kw, _ = CONFIGS[name]
    cfg = cfg or pipeline_config(small)
    viewport = (cfg.width, cfg.height)
    if kind == "bindless":
        scene, camera = build_bindless_scene(
            n_materials=64 if small else 256, n_textures=16 if small else 64, viewport=viewport)
    else:
        scene, camera = build_test_scene(viewport=viewport)
    if kind == "test_spot":
        scene.spots.append(SpotLight(
            position=np.array([1.5, 3.0, 1.0], np.float32),
            direction=np.array([-0.3, -1.0, -0.2], np.float32),
            luminous_intensity_cd=30000.0,
        ))
    return Renderer(scene, camera, cfg, device=device, **kw)


def camera_mover(renderer: Renderer):
    """A per-frame callback that slides the camera sideways and bobs it:
    3 cm a frame, so near surfaces move by several pixels at 1080p."""
    base = np.array(renderer.camera.position, np.float32)

    def move(frame: int) -> None:
        renderer.camera.position = base + np.array(
            [0.03 * frame, 0.02 * np.sin(0.4 * frame), 0.0], np.float32)

    return move


def expected_launches(renderer: Renderer, frames: int) -> int:
    """Raster launches of ``frames`` frames from a fresh Renderer whose scene
    stays as built: the camera's every frame, the sun's once, and one per
    shadow-casting spot per frame."""
    return frames * (1 + sum(renderer.cfg.scene.spot_shadow_casters)) + 1


def run_config(name: str, small: bool = False, warmup: int = 4, iters: int = 16):
    """Bench one frame kind on the card. Returns (result dict, Renderer)."""
    dev = torch.device("cuda")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rasterize_tiles_cuda.launches = 0
    renderer = build_renderer(name, small, dev)
    move = camera_mover(renderer)
    bench = renderer.benchmark(warmup=warmup, iters=iters, before_frame=move)
    before = renderer.state["TAAHistory"].clone()
    move(renderer.frame_index)
    renderer.render_frame()
    state = renderer.state
    cfg = renderer.cfg
    result = {
        "config": name, "frame": CONFIGS[name][2],
        "width": cfg.width, "height": cfg.height, "shadow_map_size": cfg.shadow_map_size,
        "passes": [p.name for p in renderer.pipeline.passes],
        "ms_per_frame": bench["ms_per_frame"],
        "ms_min": min(bench["frame_ms"]), "ms_max": max(bench["frame_ms"]),
        "wall_ms_per_frame": bench["wall_ms_per_frame"],
        "frame_ms": bench["frame_ms"], "pass_ms": bench["pass_ms"],
        "frames": renderer.frame_index,
        "raster_launches": rasterize_tiles_cuda.launches,
        "raster_launches_expected": expected_launches(renderer, renderer.frame_index),
        "ldr_finite": bool(torch.isfinite(state["LDR"]).all()),
        "coverage": state["SceneCoverage"].float().mean().item(),
        "max_velocity_px": state["SceneVelocity"].abs().max().item(),
        "taa_history_delta": (state["TAAHistory"] - before).abs().max().item(),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "device": torch.cuda.get_device_name(0), "card": card_line(),
    }
    return result, renderer


def profile_config(name: str, renderer: Renderer, frames: int = 4, top: int = 12) -> dict:
    """``frames`` more frames of ``renderer`` under torch.profiler: kernel
    time and launches per frame, the device's busy share of the frame's
    wall clock, the ``top`` operators and kernels by device time, and each
    pass's span on the device (every pass runs inside a ``record_function``
    range of its name)."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    move = camera_mover(renderer)
    pipeline = renderer.pipeline
    plain = pipeline._executes

    def ranged(pass_name, execute):
        def run(state, ctx):
            with record_function(f"pass::{pass_name}"):
                return execute(state, ctx)
        return run

    pipeline._executes = [(n, ranged(n, e)) for n, e in plain]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                move(renderer.frame_index)
                renderer.render_frame()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    finally:
        pipeline._executes = plain

    def self_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    # key_averages() lists each kernel (a device event), apart from it the
    # operator that launched it with the same time against its name, and
    # each pass's range twice: on the host and as its span on the device.
    events = prof.key_averages()
    on_device = torch.autograd.DeviceType.CUDA

    def is_pass(e):
        return e.key.startswith("pass::")

    kernels = sorted((e for e in events if e.device_type == on_device and not is_pass(e)),
                     key=self_ms, reverse=True)
    ops = sorted((e for e in events if e.device_type != on_device and self_ms(e) > 0
                  and not is_pass(e)), key=self_ms, reverse=True)
    kernel_ms = sum(self_ms(e) for e in kernels) / frames
    by_name: dict = {}  # kernels by the first 60 characters of their names
    for e in kernels:
        ms_count = by_name.setdefault(e.key[:60], [0.0, 0.0])
        ms_count[0] += self_ms(e) / frames
        ms_count[1] += e.count / frames
    return {
        "config": name, "profiled_frames": frames,
        "wall_ms_per_frame_profiled": wall_ms,
        "kernel_ms_per_frame": kernel_ms,
        "busy_share": kernel_ms / wall_ms,
        "launches_per_frame": sum(e.count for e in kernels) / frames,
        "top_ops_ms_per_frame": {e.key: [self_ms(e) / frames, e.count / frames]
                                 for e in ops[:top]},
        "top_kernels_ms_per_frame": dict(sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]),
        "pass_device_span_ms_per_frame": {e.key[6:]: self_ms(e) / frames for e in events
                                          if is_pass(e) and e.device_type == on_device},
        "device": torch.cuda.get_device_name(0), "card": card_line(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=",".join(CONFIGS),
                    help="comma-joined frame kinds (default: all of %(default)s)")
    ap.add_argument("--small", action="store_true", help="256x256 frames")
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--profile", action="store_true",
                    help="also profile 4 frames of each kind with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is False; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    for name in args.config.split(","):
        result, renderer = run_config(name, args.small, args.warmup, args.iters)
        print(json.dumps(result), flush=True)
        if args.profile:
            print(json.dumps(profile_config(name, renderer)), flush=True)
        del renderer


if __name__ == "__main__":
    main()
