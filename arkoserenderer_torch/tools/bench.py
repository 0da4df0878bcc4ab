"""Frame-time bench of the port's raster frames on the card.

The frame kinds (the reference's ``bench.py`` configs of the same names):

  forward    test scene; visibility-buffer raster + sun shadow + PBR shading +
             Bloom + TAA + tonemap
  full_post  the same + SSAO, Fog, MotionBlur and DepthOfField
  bindless   256 materials over 64 texture chains + MotionBlur + DepthOfField
  test_spot  the test scene with one shadow-casting spot light: its shadow
             map is rastered every frame (LocalShadow) and PCF-sampled
  translucent the forward frame with the two translucent panes of
             tests/test_translucent.py in front of the camera
             (``procedural.add_glass_panes``) and ``oit_layers=4``: the
             ForwardTranslucent pass peels four layers, each a camera-sized
             raster with ``depth_limit`` and a per-field shade of the whole
             screen (``ops/shading.shade_visibility_buffer``)
  rt         the same scene and spot with rt_shadows and rt_reflections: the
             sun's and the spot's shadows are rays (RTShadow, RTLocalShadow)
             and RTReflections traces mirror rays and their sun and spot
             occlusion rays, five traces a frame through the two-level BVH
  rt_soft    the rt frame with soft shadows: a sun of 10 degrees' angular
             radius and a spot of 0.35 source radius (the values of
             tests/test_soft_shadows.py), so both masks are blue-noise
             samples of the light's disk run through the shadow denoiser
  stress     4,096 animated grid cells, each a two-level LOD chain (983,042
             triangles in the pool): the forward passes with the animation
             in the frame (``make_stress_animator``), so the sun map is
             rastered every frame and the records carry previous positions
  meshlet    the same with per-meshlet culling in Geometry
  forward_upscaled  the forward passes at 1280x720 (the "quality" preset of
             1920x1080) with TemporalUpscale to 1920x1080 in place of TAA
  ddgi       the test scene with a skinned box (a one-joint skeleton) and a
             sphere with an inflate morph target (``build_anim_scene``), DDGI
             (a 16x8x16 grid fitted to the scene, 256 rays x 1,024 probes a
             frame) and SSSS: the Scene pass skins and morphs the pool,
             BVHRefit refits the BVH every frame, DDGI traces two traces a
             frame (ddgi probe, ddgi sun) through it, and the sun map is
             rastered every frame (animated geometry is not cacheable)
  showcase   the test scene with rt_shadows, rt_reflections, DDGI (an 8x4x8
             grid fitted to the scene, 128 rays x 64 probes a frame), SSAO,
             Fog and MotionBlur: five traces a frame (sun mask, reflection,
             sun occlusion, ddgi probe, ddgi sun)
  flagship   4,096 spheres (786,434 triangles) over 256 materials and 64
             texture chains, the sun, two shadow-casting spots and a point
             light, with the showcase's passes and DDGI at 256 rays x 1,024
             probes of a 16x8x16 grid: eleven traces a frame (sun mask,
             spot masks 0 and 1, reflection, sun occlusion, spot occlusions
             0 and 1, ddgi probe, ddgi sun, ddgi spots 0 and 1)
  helmet     a 6x6 grid of the DamagedHelmet glTF (assets/sample; 556,274
             triangles with the floor) with its five textures decoded and
             LANCZOS-resized to 1024^2 at import, RT sun shadows and DDGI
             (a 16x4x16 grid, 256 rays x 1,024 probes a frame): three traces
             a frame (sun mask, ddgi probe, ddgi sun) and the camera raster

and, apart from those Renderer frames, the app's path tracer:

  pathtraced the test scene at 1920x1080 through ``PathTracer(max_bounces=3,
             tonemap_mode="agx", seed=0, aa=True)``, one sample a pixel a
             call: per sample four closest-hit traces of 2,073,600 rays
             (the camera's and three bounces') and three sun-occlusion
             traces, every lane traced (``run_pathtraced``)

at 1920x1080, raster tile 8x128 with 256 triangles a tile, and an 8192^2 sun
shadow map (``--small``: 256x256, tile 8x16, a 256^2 map, 64 materials over
16 chains, 256 stress cells; the flagship 256 spheres, 64 materials, 16
chains, an 8x4x8 grid with 128 rays x 64 probes; ddgi the grid
``ProbeGridConfig.fit_bounds`` gives by default). The camera moves every
frame, so the motion vectors, the history reprojections and the motion
blur do real work; in ``stress`` and ``meshlet`` it stands still and the
motion is the grid's.

    python -m arkoserenderer_torch.tools.bench [--config forward,full_post,pathtraced] [--small]
                                               [--warmup 4] [--iters 16]
                                               [--rt-scale 2] [--ddgi-sample-scale 2]
                                               [--sky-fetch-scale k]

The reduced-rate knobs (``PipelineConfig.rt_scale``, ``ddgi_sample_scale``
and ``sky_fetch_scale``) stay at 1, the full rate, unless given: half-rate
RTShadow and RTReflections, DDGI sampled at a quarter of the pixels, the
sky's env map fetched at 1/k rate. They apply to every Renderer kind named.

prints the card's name and power limit, then for each frame kind a line
with the host's time to build its scene and its renderer (``build_line``:
the scene's authoring, for the helmet with its textures' decode and resize
timed apart; the pools, material packing and the BVH), a line with the
captured and the eager frame timed in turns in this process (``run_turns``:
blocks of ``--iters`` frames, eager, captured, captured, eager: each
block's median ms/frame by CUDA events and host wall ms/frame, the spread
between a mode's two blocks, and peak memory, the graphs' pools included;
"eager (...)" names what keeps a kind from a capture), and one JSON line:
whether the frames are captured, ms/frame (median, min, max of CUDA-event
times around each captured frame, and the host's wall clock per frame),
the median ms of every pass over 3 frames replayed as the captured
frame's chain of per-pass graphs (``pass_ms``) and over 3 eager frames
(``eager_pass_ms``), peak device memory (allocated and
reserved), the raster kernel's launches (and the count the configuration
implies), the traversal kernel's launches by trace (and the count implied),
coverage, how far the history (TAA's, or the upscaler's) moved in
one frame, and for the last STATS_FRAMES frames the triangles left after
culling, the meshlets kept and the triangles the camera's and the sun's
bins dropped, with each of those frames' checks (finite LDR, coverage and,
with DDGI, how far each atlas moved in the frame). Needs a GPU; run from
the root of a checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from arkoserenderer_torch.assets import imagecodec, sample_scenes
from arkoserenderer_torch.assets.gltf import parse_gltf
from arkoserenderer_torch.assets.procedural import (
    add_glass_panes,
    build_anim_scene,
    build_bindless_scene,
    build_flagship_scene,
    build_stress_scene,
    build_test_scene,
    make_stress_animator,
)
from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.models.pathtracer import PathTracer
from arkoserenderer_torch.models.standard import Renderer
from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda
from arkoserenderer_torch.ops.ddgi import ProbeGridConfig
from arkoserenderer_torch.ops.raster_cuda import rasterize_tiles_cuda
from arkoserenderer_torch.ops.upscale import ideal_render_resolution
from arkoserenderer_torch.rendering.passes.ddgi import STATE_KEYS as DDGI_KEYS
from arkoserenderer_torch.rendering.passes.geometry import camera_visible_triangles
from arkoserenderer_torch.rendering.passes.shadow import sun_shadow_cacheable
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, eager_frames
from arkoserenderer_torch.scene.lights import SpotLight
from arkoserenderer_torch.tools.raster_bench import card_line, forward_raster_inputs

# name -> (scene kind, pipeline flags, description)
CONFIGS = {
    "forward": ("test", {}, "forward (visbuf raster + shadow + PBR + bloom + TAA + tonemap)"),
    "full_post": ("test", dict(ssao=True, fog=True, motion_blur=True, depth_of_field=True),
                  "full post (TAA + bloom + SSAO + fog + motion blur + DoF)"),
    "bindless": ("bindless", dict(motion_blur=True, depth_of_field=True),
                 "256 materials / 64 textures bindless + TAA + motion blur + DoF"),
    "test_spot": ("test_spot", {}, "forward + one shadow-casting spot light (LocalShadow + PCF)"),
    "translucent": ("test_panes", dict(oit_layers=4),
                    "forward + two translucent panes, 4-layer depth-peeled OIT"),
    "rt": ("test_spot", dict(rt_shadows=True, rt_reflections=True),
           "RT shadows + RT reflections + denoise, one shadow-casting spot light"),
    "rt_soft": ("test_spot_soft", dict(rt_shadows=True, rt_reflections=True),
                "soft RT shadows (10 degree sun, 0.35 m spot) + shadow denoiser + RT "
                "reflections"),
    "stress": ("stress", {}, "4096 animated instances with LOD chains (culling stress)"),
    "meshlet": ("meshlet", {}, "meshlet visbuf + per-meshlet culling, 4096 instances"),
    "forward_upscaled": ("test_upscaled", {}, "forward at 2/3 scale + temporal upscale to 1080p"),
    "ddgi": ("test_anim", dict(ddgi=True, ssss=True),
             "DDGI probe GI + SSSS + skinning + morph targets"),
    "showcase": ("test", dict(rt_shadows=True, rt_reflections=True, ddgi=True, ssao=True,
                              fog=True, motion_blur=True),
                 "showcase: raster + RT shadows/reflections + DDGI + SSAO + full post"),
    "flagship": ("flagship", dict(rt_shadows=True, rt_reflections=True, ddgi="flagship",
                                  ssao=True, fog=True, motion_blur=True),
                 "flagship: 786K tris, 256 mats/64 tex, RT shadows+refl, DDGI 256x1024, "
                 "SSAO, full post"),
    "helmet": ("helmet", dict(rt_shadows=True, ddgi="helmet"),
               "helmet zoo: 36x DamagedHelmet (~556K tris, real textures), RT shadows + DDGI"),
}
# The path tracer's kind (not a Renderer frame: ``run_pathtraced``).
PATHTRACED = "pathtraced"
KINDS = (*CONFIGS, PATHTRACED)
ANIMATED = ("stress", "meshlet")  # scene kinds whose grid moves; their camera stands still
# The soft kind's light sizes (tests/test_soft_shadows.py:119 and :185).
SOFT_SUN_DEG, SOFT_SPOT_RADIUS = 10.0, 0.35
STATS_FRAMES = 2  # frames after the timed ones whose culling and bin counts are read


# The reduced-rate fields of PipelineConfig the bench takes, all 1 by default.
RATES = ("rt_scale", "ddgi_sample_scale", "sky_fetch_scale")


def pipeline_config(small: bool = False, **rates) -> PipelineConfig:
    """The bench's frame config; ``rates``: any of RATES."""
    if small:
        return PipelineConfig(width=256, height=256, shadow_map_size=256,
                              raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                              **rates)
    return PipelineConfig(width=1920, height=1080, shadow_map_size=8192,
                          raster=RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256),
                          **rates)


def build_scene(name: str, small: bool = False, cfg: PipelineConfig | None = None):
    """The host scene of frame kind ``name`` and what its Renderer takes:
    (scene, camera, pipeline config, Renderer keywords), at
    ``pipeline_config(small)`` or at ``cfg`` when given (the scene's size
    still follows ``small``). The upscaled kind renders at the "quality"
    preset of that size and upscales to it."""
    kind, kw, _ = CONFIGS[name]
    cfg = cfg or pipeline_config(small)
    if kind == "test_upscaled":
        rw, rh = ideal_render_resolution(cfg.width, cfg.height, "quality")
        kw = dict(kw, upscale_to=(cfg.width, cfg.height))
        cfg = dataclasses.replace(cfg, width=rw, height=rh)
    viewport = (cfg.width, cfg.height)
    if kind == "bindless":
        scene, camera = build_bindless_scene(
            n_materials=64 if small else 256, n_textures=16 if small else 64, viewport=viewport)
    elif kind == "flagship":
        scene, camera = build_flagship_scene(
            n_instances=256 if small else 4096, n_materials=64 if small else 256,
            n_textures=16 if small else 64, viewport=viewport)
        if kw.get("ddgi") == "flagship":
            center, radius = scene.bounding_sphere()
            kw = dict(kw, ddgi=ProbeGridConfig.fit_bounds(
                center, radius, dims=(8, 4, 8) if small else (16, 8, 16),
                rays_per_probe=128 if small else 256, probes_per_frame=64 if small else 1024))
    elif kind == "helmet":
        scene, camera = sample_scenes.build_helmet_scene(
            n_grid=3 if small else 6, viewport=viewport,
            max_texture_size=128 if small else 1024)
        if kw.get("ddgi") == "helmet":
            center, radius = scene.bounding_sphere()
            kw = dict(kw, ddgi=ProbeGridConfig.fit_bounds(
                center, radius, dims=(8, 4, 8) if small else (16, 4, 16),
                rays_per_probe=128 if small else 256, probes_per_frame=64 if small else 1024))
    elif kind in ANIMATED:
        scene, camera = build_stress_scene(n_instances=256 if small else 4096, viewport=viewport)
        scene.enable_meshlets = kind == "meshlet"
        kw = dict(kw, scene_animator=make_stress_animator(scene))
    elif kind == "test_anim":
        scene, camera = build_anim_scene(viewport=viewport)
        if not small:
            center, radius = scene.bounding_sphere()
            kw = dict(kw, ddgi=ProbeGridConfig.fit_bounds(
                center, radius, dims=(16, 8, 16), rays_per_probe=256, probes_per_frame=1024))
    else:
        scene, camera = build_test_scene(viewport=viewport)
    if kind == "test_panes":
        add_glass_panes(scene)
    if kind in ("test_spot", "test_spot_soft"):
        scene.spots.append(SpotLight(
            position=np.array([1.5, 3.0, 1.0], np.float32),
            direction=np.array([-0.3, -1.0, -0.2], np.float32),
            luminous_intensity_cd=30000.0,
        ))
    if kind == "test_spot_soft":
        scene.sun.angular_radius_deg = SOFT_SUN_DEG
        scene.spots[0].source_radius = SOFT_SPOT_RADIUS
    return scene, camera, cfg, kw


def build_renderer(name: str, small: bool = False, device="cuda",
                   cfg: PipelineConfig | None = None) -> Renderer:
    """The Renderer of frame kind ``name`` (``build_scene``'s arguments)."""
    scene, camera, cfg, kw = build_scene(name, small, cfg)
    return Renderer(scene, camera, cfg, device=device, **kw)


def camera_mover(renderer: Renderer):
    """A per-frame callback that slides the camera sideways and bobs it:
    3 cm a frame, so near surfaces move by several pixels at 1080p."""
    base = np.array(renderer.camera.position, np.float32)

    def move(frame: int) -> None:
        renderer.camera.position = base + np.array(
            [0.03 * frame, 0.02 * np.sin(0.4 * frame), 0.0], np.float32)

    return move


def _pass_names(renderer: Renderer) -> set:
    return {p.name for p in renderer.pipeline.passes}


def expected_launches_by_shape(renderer: Renderer, frames: int) -> dict:
    """Raster launches of ``frames`` frames from a fresh Renderer whose scene
    stays as built, by (height, width, depth_only): the camera's every
    frame, and with ForwardTranslucent one more per peeled layer; with
    shadow maps, the sun's once under the static shadow cache, else every
    frame, and one per shadow-casting spot per frame; with ray-traced
    shadows no other raster."""
    cfg = renderer.cfg
    s, a = cfg.shadow_map_size, cfg.local_shadow_map_size
    out = {(cfg.height, cfg.width, False): frames}
    for p in renderer.pipeline.passes:
        if p.name == "ForwardTranslucent":
            out[(cfg.height, cfg.width, False)] += p.layers * frames
    if "SunShadow" in _pass_names(renderer):
        out[(s, s, True)] = 1 if sun_shadow_cacheable(cfg.scene) else frames
        casters = sum(cfg.scene.spot_shadow_casters)
        if casters:
            out[(a, a, True)] = casters * frames
    return out


def expected_shading_launches(renderer: Renderer, frames: int) -> int:
    """Packed-shading kernel launches of ``frames`` frames: one a frame
    where VisibilityShading shades in the packed mode, else none."""
    packed = renderer.cfg.shading_mode == "packed"
    return frames if packed and "VisibilityShading" in _pass_names(renderer) else 0


def expected_trace_launches_by_label(renderer, frames: int) -> dict:
    """Traversal launches of ``frames`` frames by trace, one a frame each:
    with RTShadow the sun mask and a mask per shadow-casting spot and point
    light ("spot mask 0", ...: the light's index); with RTReflections the
    reflection rays and, at their hits, the sun's occlusion rays and one
    trace per casting spot and point light; with DDGI the probe rays and,
    at their hits, the same occlusion rays. For a ``PathTracer``
    (``frames`` samples): each bounce b's closest-hit rays "pt ray b" (the
    camera's at b = 0, one more than the bounces), and at each bounce's
    hits the sun's "pt sun b" and each casting light's "pt spot i b" /
    "pt point i b"."""
    if isinstance(renderer, PathTracer):
        lights = renderer._lights
        traces = [f"pt ray {b}" for b in range(renderer.max_bounces + 1)]
        for b in range(renderer.max_bounces):
            traces += [f"pt sun {b}",
                       *(f"pt spot {i} {b}" for i in range(lights["n_spots"])
                         if i >= len(lights["spot_casters"]) or lights["spot_casters"][i]),
                       *(f"pt point {i} {b}" for i in range(lights["n_points"])
                         if i >= len(lights["point_casters"]) or lights["point_casters"][i])]
        return {label: frames for label in traces}
    st = renderer.cfg.scene
    names = _pass_names(renderer)
    spot_casters = [i for i, cast in enumerate(st.spot_shadow_casters) if cast]
    point_casters = [i for i, cast in enumerate(st.point_shadow_casters) if cast]
    # ops/rt and ops/ddgi trace a spot beyond the casters' tuple as casting.
    spots_traced = [i for i in range(st.n_spots)
                    if i >= len(st.spot_shadow_casters) or st.spot_shadow_casters[i]]
    traces = []
    if "DDGI" in names:
        traces += ["ddgi probe", "ddgi sun", *(f"ddgi spot {i}" for i in spots_traced),
                   *(f"ddgi point {i}" for i in point_casters)]
    if "RTShadow" in names:
        traces += ["sun mask", *(f"spot mask {i}" for i in spot_casters),
                   *(f"point mask {i}" for i in point_casters)]
    if "RTReflections" in names:
        traces += ["reflection", "sun occlusion", *(f"spot occlusion {i}" for i in spots_traced),
                   *(f"point occlusion {i}" for i in point_casters)]
    return {label: frames for label in traces}


def expected_launches(renderer: Renderer, frames: int) -> int:
    return sum(expected_launches_by_shape(renderer, frames).values())


def frame_counts(renderer: Renderer) -> dict:
    """For the frame ``renderer`` renders next: the triangles left after
    culling (instance frustum and LOD, and meshlets where the scene has
    them), the meshlets kept of those in the scene, and the bin entries the
    camera's and the sun's rasters drop (``vis.overflow``), formed from the
    scene the frame sees (animated, skinned and morphed) as the Geometry
    and SunShadow passes form them. Reads the device."""
    cfg, dev = renderer.cfg, renderer.device
    cam = renderer.camera.state(renderer.frame_index, dev)
    if renderer.animated:
        renderer.upload_animation()
    scene = renderer.scene_arrays
    animator = renderer.pipeline.scene_animator
    if animator is not None:
        scene = animator(scene, renderer.frame_index, 1 / 60)
    if renderer.animated:
        geom = dict(renderer.pipeline._executes)["Scene"](
            {}, FrameContext(scene, cam, renderer.frame_index, 1 / 60))
        scene = scene._replace(positions=geom["geom.positions"], normals=geom["geom.normals"],
                               tangents=geom["geom.tangents"])
    tris, kept = camera_visible_triangles(scene, cam.view_proj, cam.position,
                                          cfg.scene.has_meshlets)
    cases = forward_raster_inputs(scene, cam, cfg.scene, cfg.width, cfg.height,
                                  cfg.shadow_map_size, cfg.raster)
    return {
        "visible_tris": int(tris.sum()),
        "meshlets_kept": None if kept is None else int(kept.sum()),
        "meshlets": None if kept is None else int(scene.meshlet_valid.sum()),
        "overflow_camera": int(cases["camera"][1].overflow),
        "overflow_sun": (int(cases["sun"][1].overflow) if "SunShadow" in _pass_names(renderer)
                         else None),
    }


def animation_paths(device, n_instances: int = 64, res: int = 128, frames: int = 3):
    """The stress grid's frame ``frames - 1`` rendered twice at ``res``^2
    (no TAA, no Bloom): animated inside the frame (``make_stress_animator``),
    and animated on the host (``animate_stress_scene`` to t = k / 60 before
    frame k) and uploaded by ``dynamic_transforms``. Returns the two LDR
    images (animator, host); they differ only where a triangle edge's
    coverage flips between the two transform paths."""
    from arkoserenderer_torch.assets.procedural import animate_stress_scene

    cfg = PipelineConfig(width=res, height=res, shadow_map_size=256,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256))
    scene_d, cam_d = build_stress_scene(n_instances=n_instances, viewport=(res, res))
    rd = Renderer(scene_d, cam_d, cfg, device=device, taa=False, bloom=False,
                  scene_animator=make_stress_animator(scene_d))
    scene_h, cam_h = build_stress_scene(n_instances=n_instances, viewport=(res, res))
    rh = Renderer(scene_h, cam_h, cfg, device=device, taa=False, bloom=False,
                  dynamic_transforms=True)
    for k in range(frames):
        img_d = rd.render_frame()
        animate_stress_scene(scene_h, k / 60)
        img_h = rh.render_frame()
    return img_d, img_h


def run_turns(renderer, iters: int, before_frame=None) -> dict:
    """The captured and the eager frame of one renderer in turns: blocks of
    ``iters`` frames, eager, captured, captured, eager (the first eager one
    after one untimed frame). Each block's median ms/frame (CUDA events
    around each frame) and host wall ms/frame, by mode; the spread of a
    mode is its two blocks' difference over their mean."""
    out = {"captured_ms": [], "eager_ms": [], "captured_wall_ms": [], "eager_wall_ms": []}
    for i, eager in enumerate((True, False, False, True)):
        b = renderer.benchmark(warmup=1 if i == 0 else 0, iters=iters,
                               before_frame=before_frame, eager=eager, pass_frames=0)
        mode = "eager" if eager else "captured"
        out[f"{mode}_ms"].append(b["ms_per_frame"])
        out[f"{mode}_wall_ms"].append(b["wall_ms_per_frame"])
    for mode in ("captured", "eager"):
        a, b = out[f"{mode}_ms"]
        out[f"{mode}_spread"] = abs(a - b) / ((a + b) / 2)
    return out


def run_config(name: str, small: bool = False, warmup: int = 4, iters: int = 16,
               rates: dict | None = None, turns: bool = False):
    """Bench one frame kind on the card: ``warmup`` + ``iters`` timed frames
    (the captured frame where the pipeline captures), the per-pass table of
    a few eager frames (``Renderer.benchmark``), with ``turns`` the captured
    and the eager frame in turns (``run_turns``), then STATS_FRAMES frames
    whose counts are read (``frame_counts``), at the reduced rates ``rates``
    (``pipeline_config``'s). Returns (result dict, Renderer)."""
    dev = torch.device("cuda")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rasterize_tiles_cuda.launches = 0
    trace_rays_cuda.launches_by_label.clear()
    t0 = time.perf_counter()
    scene, camera, cfg, kw = build_scene(name, small, pipeline_config(small, **(rates or {})))
    t1 = time.perf_counter()
    renderer = Renderer(scene, camera, cfg, device=dev, **kw)
    torch.cuda.synchronize(dev)
    host_build = {"scene_s": t1 - t0, "renderer_s": time.perf_counter() - t1,
                  **scene.build_times}
    move = None if CONFIGS[name][0] in ANIMATED else camera_mover(renderer)
    bench = renderer.benchmark(warmup=warmup, iters=iters, before_frame=move)
    in_turns = run_turns(renderer, iters, move) if turns else None
    history = "UpscaleHistory" if "UpscaleHistory" in renderer.state else "TAAHistory"
    counts, checks = [], []
    for _ in range(STATS_FRAMES):
        before = renderer.state[history].clone()
        atlases = {k: renderer.state[k].clone() for k in DDGI_KEYS if k in renderer.state}
        if move is not None:
            move(renderer.frame_index)
        counts.append(frame_counts(renderer))
        out = renderer.render_frame()
        checks.append({
            "ldr_finite": bool(torch.isfinite(out).all()),
            "coverage": renderer.state["SceneCoverage"].float().mean().item(),
            **{f"{k}_delta": (renderer.state[k] - v).abs().max().item()
               for k, v in atlases.items()},
        })
    state = renderer.state
    cfg = renderer.cfg
    ldr = state.get("LDRDisplay", state["LDR"])
    result = {
        "config": name, "frame": CONFIGS[name][2],
        "width": cfg.width, "height": cfg.height, "shadow_map_size": cfg.shadow_map_size,
        "rates": {r: getattr(cfg, r) for r in RATES},
        "display": list(ldr.shape[:2]),
        "passes": [p.name for p in renderer.pipeline.passes],
        "captured": bench["captured"],
        "blocked_by": renderer.pipeline.capture_blockers,
        "ms_per_frame": bench["ms_per_frame"],
        "ms_min": min(bench["frame_ms"]), "ms_max": max(bench["frame_ms"]),
        "wall_ms_per_frame": bench["wall_ms_per_frame"],
        "frame_ms": bench["frame_ms"], "pass_ms": bench["pass_ms"],
        "pass_ms_from": bench["pass_ms_from"], "eager_pass_ms": bench["eager_pass_ms"],
        "turns": in_turns,
        "frames": renderer.frame_index, "host_build": host_build,
        "raster_launches": rasterize_tiles_cuda.launches,
        "raster_launches_expected": expected_launches(renderer, renderer.frame_index),
        "trace_launches": dict(trace_rays_cuda.launches_by_label),
        "trace_launches_expected": expected_trace_launches_by_label(renderer,
                                                                    renderer.frame_index),
        "ldr_finite": bool(torch.isfinite(ldr).all()),
        "coverage": state["SceneCoverage"].float().mean().item(),
        "max_velocity_px": state["SceneVelocity"].abs().max().item(),
        "history": history,
        "history_delta": (state[history] - before).abs().max().item(),
        "frame_counts": counts, "frame_checks": checks,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
        "device": torch.cuda.get_device_name(0), "card": card_line(),
    }
    return result, renderer


def build_pathtracer(small: bool = False, device="cuda", scene=None) -> PathTracer:
    """The ``pathtraced`` kind's tracer: the app's default scene and
    settings at 1920x1080 (``small``: 256x256); ``scene`` is that scene and
    its camera when the caller built them."""
    w, h = (256, 256) if small else (1920, 1080)
    scene, camera = scene or build_test_scene(viewport=(w, h))
    return PathTracer(scene, camera, w, h, max_bounces=3, tonemap_mode="agx", seed=0, aa=True,
                      device=device)


def time_samples(tracer, n: int, eager: bool = False) -> dict:
    """``n`` samples of ``tracer``, each timed by CUDA events: captured
    (a replay of the sample's graph) or, with ``eager``, eager. Their ms
    (median, each), the host wall ms a sample (the synchronised clock) and
    the peak memory allocated over them."""
    dev = tracer.device
    events = []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with eager_frames() if eager else contextlib.nullcontext():
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tracer.render_sample(1)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
    ms = [s.elapsed_time(e) for s, e in events]
    return {"ms": statistics.median(ms), "sample_ms": ms,
            "wall_ms": (time.perf_counter() - t0) * 1e3 / max(n, 1),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def sample_turns(tracer, iters: int) -> dict:
    """The captured and the eager sample of one tracer in turns: blocks of
    ``iters`` samples, eager, captured, captured, eager (``time_samples``),
    each block's median ms a sample and host wall ms, by mode, and each
    mode's spread (its two blocks' difference over their mean)."""
    out = {"captured_ms": [], "eager_ms": [], "captured_wall_ms": [], "eager_wall_ms": []}
    for eager in (True, False, False, True):
        b = time_samples(tracer, iters, eager)
        mode = "eager" if eager else "captured"
        out[f"{mode}_ms"].append(b["ms"])
        out[f"{mode}_wall_ms"].append(b["wall_ms"])
    for mode in ("captured", "eager"):
        a, b = out[f"{mode}_ms"]
        out[f"{mode}_spread"] = abs(a - b) / ((a + b) / 2)
    return out


def run_pathtraced(small: bool = False, warmup: int = 4, iters: int = 16,
                   turns: bool = False):
    """Bench the path tracer on the card: ``warmup`` + ``iters`` samples
    (captured: replays of the sample's graph), each timed by CUDA events;
    ms a sample (median, min, max), rays a second (every lane of every
    trace counted), the traversal launches by trace against those implied,
    finite radiance and LDR, peak memory and the host build; with
    ``turns`` the captured and the eager sample in turns (``sample_turns``,
    ``iters`` samples a block). Returns (result dict, PathTracer)."""
    dev = torch.device("cuda")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trace_rays_cuda.launches_by_label.clear()
    t0 = time.perf_counter()
    scene = build_test_scene(viewport=(256, 256) if small else (1920, 1080))
    t1 = time.perf_counter()
    tracer = build_pathtracer(small, dev, scene)
    torch.cuda.synchronize(dev)
    host_build = {"scene_s": t1 - t0, "renderer_s": time.perf_counter() - t1,
                  **tracer.scene.build_times}
    tracer.render_sample(warmup)
    events = []
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tracer.render_sample(1)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t2) * 1e3 / max(iters, 1)
    sample_ms = [s.elapsed_time(e) for s, e in events]
    samples = tracer.sample_count
    want = expected_trace_launches_by_label(tracer, samples)
    rays = tracer.width * tracer.height * len(want)
    ms = statistics.median(sample_ms)
    radiance = tracer.radiance()
    ldr = tracer.ldr()
    in_turns = sample_turns(tracer, iters) if turns else None
    result = {
        "config": PATHTRACED, "frame": "path tracer: test scene, 3 bounces, AgX, AA",
        "captured": tracer.captured, "turns": in_turns,
        "width": tracer.width, "height": tracer.height, "max_bounces": tracer.max_bounces,
        "ms_per_sample": ms, "ms_min": min(sample_ms), "ms_max": max(sample_ms),
        "wall_ms_per_sample": wall_ms, "sample_ms": sample_ms, "samples": samples,
        "rays_per_sample": rays, "rays_per_s": rays / (ms * 1e-3),
        "trace_launches": dict(trace_rays_cuda.launches_by_label),
        "trace_launches_expected": want, "host_build": host_build,
        "radiance_finite": bool(torch.isfinite(radiance).all()),
        "ldr_finite": bool(torch.isfinite(ldr).all()),
        "mean_radiance": radiance.mean().item(), "mean_ldr": ldr.mean().item(),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
        "device": torch.cuda.get_device_name(0), "card": card_line(),
    }
    return result, tracer


def texture_times(small: bool = False) -> dict:
    """Host seconds to decode the helmet's five textures
    (``imagecodec.decode_image``) and to LANCZOS-resize them to the bench's
    size, the two steps of its import that stand where the reference calls
    PIL (the decoder built beforehand)."""
    size = 128 if small else 1024
    g = parse_gltf(sample_scenes.find_sample("DamagedHelmet") / "DamagedHelmet.gltf")
    files = [(g.base_dir / img["uri"]).read_bytes() for img in g.doc["images"]]
    imagecodec.build_decoder()
    t0 = time.perf_counter()
    images = [imagecodec.decode_image(data) for data in files]
    t1 = time.perf_counter()
    for img in images:
        imagecodec.resize_lanczos(img, (size, size))
    return {"decode_s": t1 - t0, "resize_s": time.perf_counter() - t1,
            "textures": [list(img.shape) for img in images]}


def build_line(name: str, result: dict, textures: dict | None = None) -> str:
    """The host build of a frame kind's run on one line: the scene's
    authoring (for the helmet, the glTF import with its texture decode and
    resize), then the Renderer (the pools, material packing, the BVH, the
    upload and the passes' construction)."""
    b = result["host_build"]
    line = (f"{name}: host build {b['scene_s'] + b['renderer_s']:.3f} s = scene "
            f"{b['scene_s']:.3f} s")
    if textures is not None:
        line += (f" (of which decoding {len(textures['textures'])} textures "
                 f"{textures['decode_s']:.3f} s and resizing them {textures['resize_s']:.3f} s, "
                 f"timed apart)")
    return (line + f" + renderer {b['renderer_s']:.3f} s (pools {b['pools_s']:.3f} s, material "
            f"packing {b['packing_s']:.3f} s, BVH {b['bvh_s']:.3f} s)")


def turns_line(name: str, result: dict, unit: str = "frame") -> str:
    """The captured and the eager frame (or ``unit``) of a run's turns
    (``run_config(turns=True)``, ``run_pathtraced(turns=True)``) on one
    line, with the card."""
    t = result["turns"]
    mode = "captured" if result["captured"] else f"eager ({result.get('blocked_by')})"
    return (f"{name}: {mode}; in turns: captured {t['captured_ms'][0]:.4f} / "
            f"{t['captured_ms'][1]:.4f} ms/{unit} (spread {t['captured_spread']:.2%}, host wall "
            f"{t['captured_wall_ms'][0]:.4f} / {t['captured_wall_ms'][1]:.4f}), eager "
            f"{t['eager_ms'][0]:.4f} / {t['eager_ms'][1]:.4f} ms/{unit} (spread "
            f"{t['eager_spread']:.2%}, host wall {t['eager_wall_ms'][0]:.4f} / "
            f"{t['eager_wall_ms'][1]:.4f}); peak memory {result['peak_memory_gib']:.3f} GiB "
            f"allocated, {result['peak_reserved_gib']:.3f} GiB reserved, graph pools included "
            f"[{result['card']}]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=",".join(KINDS),
                    help="comma-joined frame kinds (default: all of %(default)s)")
    ap.add_argument("--small", action="store_true", help="256x256 frames")
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--rt-scale", type=int, default=1, help="RT rate: 1 or 2 (half rate)")
    ap.add_argument("--ddgi-sample-scale", type=int, default=1,
                    help="DDGI sampling rate: 1 or 2 (a quarter of the pixels)")
    ap.add_argument("--sky-fetch-scale", type=int, default=1,
                    help="sky env-map fetch at 1/k rate, bilinearly upsampled")
    args = ap.parse_args(argv)
    rates = dict(rt_scale=args.rt_scale, ddgi_sample_scale=args.ddgi_sample_scale,
                 sky_fetch_scale=args.sky_fetch_scale)
    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is False; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    for name in args.config.split(","):
        if name == PATHTRACED:
            result, tracer = run_pathtraced(args.small, args.warmup, args.iters, turns=True)
            print(build_line(name, result), flush=True)
            print(turns_line(name, result, "sample"), flush=True)
            print(json.dumps(result), flush=True)
            del tracer
            continue
        textures = texture_times(args.small) if name == "helmet" else None
        result, renderer = run_config(name, args.small, args.warmup, args.iters, rates,
                                      turns=True)
        print(build_line(name, result, textures), flush=True)
        print(turns_line(name, result), flush=True)
        print(json.dumps(result), flush=True)
        del renderer


if __name__ == "__main__":
    main()
