"""Showcase app: the renderer's demo and headless frame loop (port of
arkoserenderer_tpu/apps/showcase.py).

Builds a scene (the procedural test scene, a glTF file, or the reference's
own .arklvl level or .arkmsh mesh, JSON or binary), renders N frames of the
forward pipeline with the flags' passes, and writes the last frame as a
PNG; ``--pathtracer`` renders the path tracer's samples instead. It runs on
the card.

Usage:
  python -m arkoserenderer_torch.apps.showcase --frames 8 --out frame.png
  python -m arkoserenderer_torch.apps.showcase --gltf path/to.gltf --width 512
  python -m arkoserenderer_torch.apps.showcase --gltf level.arklvl --oit-layers 2
  python -m arkoserenderer_torch.apps.showcase --pathtracer --samples 64

The flags are the reference's, with its defaults (``--out`` defaults to a
file in the temporary directory). The overlays: ``--debug-draw`` draws the
world axes and a box of half the scene's bounding radius, ``--light-icons``
the local lights' bulbs, and ``--ddgi-probe-debug`` (with ``--ddgi``) the
probes.

The pieces are functions so a caller can hold the app's own frames:
``build_scene(args)``, ``make_renderer(args, scene, cam, device)``,
``render(args, renderer)`` (the timed frames, the per-pass table, the PNG)
and ``main(argv, device)``, which returns the Renderer or the PathTracer.
The reference's ``enable_compile_cache()`` has no counterpart: it keeps
XLA's compiled programs across processes, and the port compiles nothing
but its CUDA kernels, which ``ops/raster_cuda.build_kernels`` caches
itself.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", type=str,
                   default=os.path.join(tempfile.gettempdir(), "arkose_torch_frame.png"))
    p.add_argument("--gltf", type=str, default=None, help="render a glTF file")
    p.add_argument("--pathtracer", action="store_true", help="ground-truth mode")
    p.add_argument("--samples", type=int, default=32, help="path tracer spp")
    p.add_argument("--texture-quality", type=str, default="trilinear",
                   help="texture filter: trilinear (8 taps), bilinear "
                        "(nearest-mip, 4 taps), anisoN (N-tap anisotropic, "
                        "e.g. aniso4), stochastic/stochastic1 (TAA-converged "
                        "jittered taps), sorted")
    p.add_argument("--tonemap", type=str, default="agx",
                   choices=["clamp", "reinhard", "aces", "agx", "khronos_pbr_neutral"])
    p.add_argument("--ssao", action="store_true")
    p.add_argument("--rt-shadows", action="store_true")
    p.add_argument("--sun-angular-radius", type=float, default=0.0,
                   help="sun disk angular radius in degrees (> 0 with "
                        "--rt-shadows = cone-sampled soft shadows + sigma "
                        "denoiser; real sun ~0.265)")
    p.add_argument("--rt-reflections", action="store_true")
    p.add_argument("--ddgi", action="store_true")
    p.add_argument("--ddgi-probe-debug", action="store_true",
                   help="overlay irradiance-colored probe splats (needs --ddgi)")
    p.add_argument("--ssss", action="store_true")
    p.add_argument("--fog", action="store_true")
    p.add_argument("--upscale", type=float, default=None,
                   help="display scale factor (DLSS-slot upscaler)")
    p.add_argument("--upscale-mode", type=str, default="temporal",
                   choices=["temporal", "spatial"],
                   help="temporal = TAA-U super-resolution (DLSS-equivalent); "
                        "spatial = FSR1-style resample + RCAS")
    p.add_argument("--motion-blur", action="store_true")
    p.add_argument("--dof", action="store_true")
    p.add_argument("--no-taa", action="store_true")
    p.add_argument("--no-bloom", action="store_true")
    p.add_argument("--debug-draw", action="store_true")
    p.add_argument("--light-icons", action="store_true",
                   help="lightbulb billboards at local light positions")
    p.add_argument("--oit-layers", type=int, default=1,
                   help="translucent depth-peeling layer count (exact OIT)")
    p.add_argument("--timings", action="store_true", help="print per-pass ms")
    p.add_argument("--timings-deadline", type=float, default=None,
                   help="wall-clock budget (s) for the per-pass table; "
                        "emits a partial table when it expires")
    return p


def build_scene(args):
    """(scene, camera): the procedural test scene, or the file of ``--gltf``
    (textures at most 256 texels a side): a glTF, an .arkmsh (each segment
    instanced at the origin) or an .arklvl (its objects, lights, first
    camera and environment map). A default sun lights a scene that brings
    none, the gradient sky stands in for a missing environment map, and
    without a level camera the camera frames the bounding sphere."""
    from arkoserenderer_torch.assets.procedural import build_test_scene, gradient_env_map
    from arkoserenderer_torch.core.types import SceneLimits
    from arkoserenderer_torch.scene.camera import Camera
    from arkoserenderer_torch.scene.lights import DirectionalLight
    from arkoserenderer_torch.scene.scene import Scene

    if args.gltf is None:
        return build_test_scene(viewport=(args.width, args.height))
    from arkoserenderer_torch.assets.gltf import load_gltf

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 19, max_indices=3 << 19, max_drawables=1024,
        max_materials=256, max_textures=256, texture_pool_texels=1 << 23,
    ))
    lvl_cam, env_loaded = None, False
    src = str(args.gltf)
    if src.endswith(".arklvl"):
        from arkoserenderer_torch.assets.ark import load_arklvl

        res = load_arklvl(scene, src, max_texture_size=256)
        lvl_cam = res["cameras"][0] if res["cameras"] else None
        env_loaded = res["env"]
    elif src.endswith(".arkmsh"):
        from arkoserenderer_torch.assets.ark import load_arkmsh

        for sid in load_arkmsh(scene, src, max_texture_size=256):
            scene.add_instance(sid, np.eye(4, dtype=np.float32))
    else:
        load_gltf(scene, src, max_texture_size=256)
    if scene.sun is None:
        scene.sun = DirectionalLight(direction=np.array([0.35, -1.0, -0.25], np.float32))
    if not env_loaded:
        scene.set_env_map(gradient_env_map(32), brightness=8000.0)
        scene.ambient_lx = 6000.0
    if lvl_cam is not None:
        lvl_cam.viewport = (args.width, args.height)
        return scene, lvl_cam
    cam = Camera(viewport=(args.width, args.height))
    center, radius = scene.bounding_sphere()
    cam.look_at(center + np.array([radius * 1.2, radius * 0.5, radius * 1.2]), center)
    cam.focus_depth = float(radius * 1.5)
    return scene, cam


def make_renderer(args, scene, cam, device="cuda", **cfg_kw):
    """The app's Renderer: PipelineConfig at the flags' size and filters,
    tile 8x16 with 512 triangles a tile, a 1024^2 sun map, and the
    overlays the flags ask for (``--debug-draw``'s axes and box drawn into
    ``renderer.debug``); ``cfg_kw`` overrides further PipelineConfig fields
    (a caller's, not a flag)."""
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig

    cfg = PipelineConfig(
        width=args.width, height=args.height,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
        shadow_map_size=1024,
        tonemap_mode=args.tonemap,
        texture_quality=args.texture_quality,
        **cfg_kw,
    )
    upscale_to = None
    if args.upscale:
        upscale_to = (int(args.width * args.upscale), int(args.height * args.upscale))
    r = Renderer(
        scene, cam, cfg, device=device,
        taa=not args.no_taa, bloom=not args.no_bloom,
        ssao=args.ssao, motion_blur=args.motion_blur, depth_of_field=args.dof,
        rt_shadows=args.rt_shadows, rt_reflections=args.rt_reflections,
        ddgi=True if args.ddgi else None, ssss=args.ssss, fog=args.fog,
        ddgi_probe_debug=args.ddgi_probe_debug,
        upscale_to=upscale_to, upscale_mode=args.upscale_mode,
        debug_draw=args.debug_draw, light_icons=args.light_icons, oit_layers=args.oit_layers,
    )
    if args.debug_draw:
        r.debug.axes(size=1.0)
        center, radius = scene.bounding_sphere()
        r.debug.box(center - radius * 0.5, center + radius * 0.5)
    return r


def sync_device(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU):
    the apps stop their host clock after it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render(args, r) -> dict:
    """One warm-up frame, then ``--frames`` timed frames (the host's clock,
    synchronised), the per-pass table under ``--timings`` (before the PNG
    readback, as the reference orders it), and the last frame written to
    ``--out``. Returns {"image": the last frame on the device,
    "ms_per_frame", "timings" (None without the flag)}."""
    from arkoserenderer_torch.utils.imageio import save_png

    out = r.render_frame()
    sync_device(r.device)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        out = r.render_frame()
    sync_device(r.device)
    dt = (time.perf_counter() - t0) / max(args.frames, 1)
    timings = None
    if args.timings:
        from arkoserenderer_torch.utils.timing import format_timings, time_passes

        timings = time_passes(
            r.pipeline, r.pipeline.initial_state(), r.scene_arrays,
            r.camera.state(1, r.device), deadline_s=args.timings_deadline,
            emit=lambda s: print(s, flush=True),
        )
        print(format_timings(timings))
    save_png(args.out, out.cpu().numpy())
    print(f"{args.frames} frames @ {dt * 1e3:.2f} ms/frame -> {args.out}")
    return {"image": out, "ms_per_frame": dt * 1e3, "timings": timings}


def main(argv=None, device="cuda"):
    """Run the app with ``argv`` (the command line's when None) on
    ``device``; returns the Renderer, or the PathTracer under
    ``--pathtracer``."""
    from arkoserenderer_torch.utils.imageio import save_png

    args = build_arg_parser().parse_args(argv)
    device = torch.device(device)
    scene, cam = build_scene(args)
    if args.sun_angular_radius > 0.0 and scene.sun is not None:
        scene.sun.angular_radius_deg = args.sun_angular_radius

    if args.pathtracer:
        from arkoserenderer_torch.models.pathtracer import PathTracer

        tracer = PathTracer(scene, cam, args.width, args.height, tonemap_mode=args.tonemap,
                            device=device)
        t0 = time.perf_counter()
        tracer.render_sample(args.samples)
        img = tracer.ldr().cpu().numpy()
        dt = time.perf_counter() - t0
        save_png(args.out, img)
        print(f"path traced {args.samples} spp in {dt:.2f}s -> {args.out}")
        return tracer

    r = make_renderer(args, scene, cam, device)
    render(args, r)
    return r


if __name__ == "__main__":
    main()
