"""Standard pipeline assembly and the frame loop (port of
arkoserenderer_tpu/models/standard.py, the raster and ray-traced frames).

The pass order is the reference's: Scene -> Geometry -> [BVHRefit] ->
[DDGI] -> (SunShadow -> [LocalShadow] | RTShadow -> [RTLocalShadow]) ->
VisibilityShading -> [RTReflections] -> [SSAO] -> LightingCompose ->
[SSSS] -> SkyView -> [ForwardTranslucent] -> [Fog] -> [MotionBlur] ->
[DepthOfField] -> [Bloom] ->
[TAA] -> Output -> [FXAA] -> [CAS] -> [TemporalUpscale | Upscale]. With
``rt_shadows``, ``rt_reflections`` or ``ddgi`` the Renderer builds the
scene with its two-level BVH, and on a skinned or morphed scene refits it
every frame (``rt_refit``). A scene with translucent materials gets the
depth-peeled ForwardTranslucent pass (``oit_layers`` layers). The debug
overlays come last, in the reference's order: DebugDraw (``debug_draw``, a
``DebugLineBuffer``), DDGIProbeDebug (``ddgi_probe_debug``, with DDGI
only) and IconBillboards (``light_icons``).

``Renderer`` is the host frame loop, with the reference's host API:
checkpoints of the persistent state (the reference's npz layout, so one
package's checkpoint loads into the other), picking, the frame retry and
the pipeline rebuild that keeps the persistent state, and auto-exposure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import statistics
import time

import numpy as np
import torch

from arkoserenderer_torch.ops.ddgi import ProbeGridConfig
from arkoserenderer_torch.rendering.passes import (
    BloomPass,
    CASPass,
    DepthOfFieldPass,
    FogPass,
    FXAAPass,
    GeometryPass,
    LightingComposePass,
    LocalShadowPass,
    MotionBlurPass,
    OutputPass,
    ScenePass,
    SkyPass,
    SSAOPass,
    SunShadowPass,
    TAAPass,
    TemporalUpscalePass,
    TranslucentPass,
    UpscalePass,
    VisibilityShadingPass,
)
from arkoserenderer_torch.rendering.passes.ddgi import DDGIPass
from arkoserenderer_torch.rendering.passes.ddgi_debug import DDGIProbeDebugPass
from arkoserenderer_torch.rendering.passes.debugdraw import DebugDrawPass, DebugLineBuffer
from arkoserenderer_torch.rendering.passes.icons import IconBillboardPass
from arkoserenderer_torch.rendering.passes.rt import (
    BVHRefitPass,
    RTLocalShadowPass,
    RTReflectionsPass,
    RTShadowPass,
)
from arkoserenderer_torch.rendering.passes.ssss import SSSSPass
from arkoserenderer_torch.rendering.pipeline import (
    PipelineConfig,
    RenderPipeline,
    eager_frames,
)
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.scene import Scene
from arkoserenderer_torch.utils.profiling import zone


def make_forward_pipeline(
    cfg: PipelineConfig,
    *,
    taa: bool = True,
    bloom: bool = True,
    shadows: bool = True,
    ssao: bool = False,
    fog: bool = False,
    motion_blur: bool = False,
    depth_of_field: bool = False,
    fxaa: bool = False,
    cas: bool = False,
    rt_shadows: bool = False,
    rt_reflections: bool = False,
    ddgi: ProbeGridConfig | None = None,
    ddgi_probe_debug: bool = False,  # probe discs over the image (with ddgi)
    light_icons: bool = False,       # bulb billboards at the local lights
    ssss: bool = False,
    rt_refit: bool = False,
    oit_layers: int = 1,
    upscale_to: tuple[int, int] | None = None,  # display (width, height)
    upscale_mode: str = "temporal",  # "temporal" (TemporalUpscale, no TAA) | "spatial"
    film_grain: float = 0.0,
    vignette: float = 0.18,  # 0 disables
    debug_draw: DebugLineBuffer | None = None,  # a line buffer adds the overlay
    device="cuda",
) -> RenderPipeline:
    """The raster backbone; passes run in the order they are added. The
    flags keep the reference's names and defaults. With ``upscale_to`` the
    frame renders at ``cfg``'s size, the texture LOD is biased by
    log2(render / display width) unless ``cfg.mip_bias`` is set, and an
    upscale pass publishes LDRDisplay at the display size; the temporal
    one replaces TAA. ``rt_shadows`` traces the sun's and the casting local
    lights' shadows in place of their shadow maps; ``rt_reflections`` adds
    ray-traced reflections; ``ddgi`` (a ``ProbeGridConfig``) adds the DDGI
    probe update after Geometry, whose irradiance then lights
    LightingCompose and the reflections' hits. All three trace the scene's
    ``bvh`` (build it with ``Scene.build(with_bvh=True)``, as ``Renderer``
    does); with ``rt_refit`` a BVHRefit pass after Geometry refits it to the
    frame's animated geometry first. ``ssss`` adds screen-space subsurface
    scattering after LightingCompose. The overlays draw over the final
    image: ``debug_draw``'s lines, ``ddgi``'s probes under
    ``ddgi_probe_debug`` (ignored without ``ddgi``, as in the reference)
    and the local lights' icons under ``light_icons``."""
    if upscale_mode not in ("temporal", "spatial"):
        raise ValueError(f"unknown upscale_mode {upscale_mode!r}")
    if ddgi is not None and not isinstance(ddgi, ProbeGridConfig):
        raise TypeError(f"ddgi takes a ProbeGridConfig (Renderer resolves True), not {ddgi!r}")
    # "auto" resolves as the reference's does: trilinear textures, the
    # bilinear VSM sun.
    if cfg.texture_quality == "auto":
        cfg = dataclasses.replace(cfg, texture_quality="trilinear")
    if cfg.shadow_filter == "auto":
        cfg = dataclasses.replace(cfg, shadow_filter="bilinear")
    if upscale_to is not None and cfg.mip_bias == 0.0:
        cfg = dataclasses.replace(cfg, mip_bias=math.log2(cfg.width / upscale_to[0]))
    temporal_upscale = upscale_to is not None and upscale_mode == "temporal"
    pipe = RenderPipeline(cfg, device=device)
    pipe.add_pass(ScenePass())
    pipe.add_pass(GeometryPass())
    if rt_refit and (rt_shadows or rt_reflections or ddgi is not None):
        pipe.add_pass(BVHRefitPass())
    if ddgi is not None:
        pipe.add_pass(DDGIPass(ddgi))
    st = cfg.scene
    if rt_shadows:
        pipe.add_pass(RTShadowPass())
        if any(st.spot_shadow_casters) or any(st.point_shadow_casters):
            pipe.add_pass(RTLocalShadowPass())
    elif shadows:
        pipe.add_pass(SunShadowPass())
        if any(st.spot_shadow_casters) and st.n_spots > 0:
            pipe.add_pass(LocalShadowPass())
    pipe.add_pass(VisibilityShadingPass())
    if rt_reflections:
        pipe.add_pass(RTReflectionsPass(ddgi_grid=ddgi))
    if ssao:
        pipe.add_pass(SSAOPass())
    pipe.add_pass(LightingComposePass(ddgi_grid=ddgi))
    if ssss:
        pipe.add_pass(SSSSPass())
    pipe.add_pass(SkyPass())
    if st.has_translucent:
        pipe.add_pass(TranslucentPass(layers=oit_layers))
    if fog:
        pipe.add_pass(FogPass())
    if motion_blur:
        pipe.add_pass(MotionBlurPass())
    if depth_of_field:
        pipe.add_pass(DepthOfFieldPass())
    if bloom:
        pipe.add_pass(BloomPass())
    if taa and not temporal_upscale:
        pipe.add_pass(TAAPass())
    pipe.add_pass(OutputPass(film_grain_gain=film_grain, vignette_intensity=vignette))
    if fxaa:
        pipe.add_pass(FXAAPass())
    if cas:
        pipe.add_pass(CASPass())
    if temporal_upscale:
        pipe.add_pass(TemporalUpscalePass(*upscale_to))
    elif upscale_to is not None:
        pipe.add_pass(UpscalePass(*upscale_to))
    if debug_draw is not None:
        pipe.add_pass(DebugDrawPass(debug_draw))
    if ddgi_probe_debug and ddgi is not None:
        pipe.add_pass(DDGIProbeDebugPass(ddgi))
    if light_icons:
        pipe.add_pass(IconBillboardPass())
    pipe.construct_all()
    return pipe


class Renderer:
    """Host frame loop: owns the pipeline, the persistent frame state and
    the camera's previous-frame bookkeeping. Nothing is read back from the
    device per frame, unless ``auto_exposure`` is on: then, as in the
    reference, each frame reads the metered Metering.avgLum back (one
    scalar) and nudges ``camera.exposure_compensation`` toward mid-grey at
    ``camera.adaption_rate``. It runs on the card unless ``device`` asks
    for the CPU; without a card the default raises, as torch does.

    Moving instances: ``scene_animator`` (``fn(scene_arrays, frame_index,
    delta_time) -> scene_arrays``) animates the scene inside each frame;
    ``dynamic_transforms=True`` uploads the host's instance transforms
    (``Scene.update_instance_transforms``) before each frame. Either one
    makes the scene dynamic: the shading records carry previous positions
    and the sun map is rastered every frame.

    Skinned and morphed scenes: before each frame the host evaluates the
    animations at ``time`` (``Scene.update_animations``) and uploads the
    palette and the morph weights; ``time`` advances by each frame's
    ``delta_time``. Under ray tracing such a scene turns ``rt_refit`` on
    unless the caller sets it.

    ``ddgi=True`` fits the probe grid to the scene's bounding sphere.
    ``debug_draw=True`` makes ``self.debug``, a ``DebugLineBuffer`` whose
    lines each frame draws (its arrays uploaded as ``debug.lines``)."""

    @property
    def scene_arrays(self):
        return self._scene_arrays

    @scene_arrays.setter
    def scene_arrays(self, value):
        # Any scene-data swap bumps the version that invalidates the cached
        # static sun shadow map.
        self._scene_arrays = value
        self._scene_version = getattr(self, "_scene_version", -1) + 1

    def __init__(self, scene: Scene, camera: Camera, cfg: PipelineConfig,
                 device="cuda", dynamic_transforms: bool = False, scene_animator=None,
                 auto_exposure: bool = False, debug_draw: bool = False, **pipeline_kw):
        self.debug = None
        if debug_draw:
            self.debug = DebugLineBuffer()
            pipeline_kw["debug_draw"] = self.debug
        self.device = torch.device(device)
        self.auto_exposure = auto_exposure
        self.scene_animator = scene_animator
        self.scene = scene
        self.camera = camera
        self.dynamic_transforms = dynamic_transforms
        static = scene.static_info()
        if dynamic_transforms or scene_animator is not None:
            static = dataclasses.replace(static, dynamic=True)
        self.cfg = dataclasses.replace(cfg, scene=static)
        if pipeline_kw.get("ddgi") is True:
            center, radius = scene.bounding_sphere()
            pipeline_kw["ddgi"] = ProbeGridConfig.fit_bounds(center, radius)
        use_rt = bool(pipeline_kw.get("rt_shadows") or pipeline_kw.get("rt_reflections")
                      or pipeline_kw.get("ddgi"))
        self.animated = static.has_skin or static.has_morphs
        if use_rt and self.animated:
            pipeline_kw.setdefault("rt_refit", True)
        self._pipeline_kw = dict(pipeline_kw)  # for reconstruct(rebuild_passes=True)
        self.pipeline = make_forward_pipeline(self.cfg, device=self.device, **pipeline_kw)
        self.pipeline.scene_animator = scene_animator
        self.scene_arrays = scene.build(self.device, with_bvh=use_rt)
        self.state = self.pipeline.initial_state()
        self.frame_index = 0
        self.time = 0.0

    def render_frame(self, delta_time: float = 1 / 60,
                     pass_events: list | None = None) -> torch.Tensor:
        """Render one frame; returns the LDR image on the device: (H, W, 3),
        or LDRDisplay at the display size when the pipeline upscales. On
        the card the frame is the pipeline's captured one
        (``RenderPipeline.render_frame``): the image is the graph's buffer,
        which the next frame overwrites, so copy a frame to keep it.
        ``pass_events`` (a list) takes each pass's (name, start, end) CUDA
        events: the captured frame's chain of per-pass graphs, or the eager
        frame's (within ``eager_frames()``). The frame's host stages are
        zones (``utils/profiling``: spans ``arkose.frame#<i>`` and its
        children while a profiler records)."""
        fi, record = self.frame_index, self.pipeline.record
        with zone("arkose.frame", frame=fi, record=record):
            if self.dynamic_transforms or self.animated:
                with zone("arkose.frame.scene", frame=fi, record=record):
                    if self.dynamic_transforms:
                        self.scene_arrays = self.scene.update_instance_transforms(
                            self.scene_arrays)
                    if self.animated:
                        self.upload_animation()
            persistent = self.pipeline.registry.persistent_names
            inputs = {k: self.state[k] for k in persistent if k in self.state}
            if "scene.version" in persistent:
                inputs["scene.version"] = self._scene_version
            with zone("arkose.frame.camera", frame=fi, record=record):
                cam_state = self.camera.state(self.frame_index, self.device)
            self.state = self.pipeline.render_frame(
                inputs, self.scene_arrays, cam_state, self.frame_index, delta_time,
                pass_events=pass_events,
            )
            self.camera.post_render()
            if self.auto_exposure and "Metering.avgLum" in self.state:
                # Eye adaption: the metered pre-exposed luminance nudges the
                # relative EV toward mid-grey (the reference's loop, R2: it
                # reads the scalar back every frame, after the frame, outside
                # the captured graph).
                with zone("arkose.frame.exposure", frame=fi, record=record):
                    avg = float(self.state["Metering.avgLum"])
                cam = self.camera
                cam.exposure_compensation += float(
                    np.clip(np.log2(0.18 / max(avg, 1e-6)), -4, 4)
                ) * min(cam.adaption_rate * 60.0 * delta_time * 20, 1.0)
                cam.exposure_compensation = float(np.clip(cam.exposure_compensation, -8.0, 8.0))
            self.frame_index += 1
            self.time += delta_time
        return self.state.get("LDRDisplay", self.state["LDR"])

    def frame_records(self) -> dict:
        """A host copy of the pipeline's frame record
        (``utils.profiling.FrameRecord.rows``): the rows of the frames it
        holds, by frame index, with the pass and counter names. The only
        readback of the record; it waits for the device."""
        return self.pipeline.record.rows()

    def render_frame_safe(self, delta_time: float = 1 / 60, retries: int = 2) -> torch.Tensor:
        """``render_frame`` with recovery: when a frame raises, the pipeline
        is rebuilt with its persistent state kept (``reconstruct``) and the
        frame retried, up to ``retries`` times; the last failure raises."""
        for attempt in range(retries + 1):
            try:
                return self.render_frame(delta_time)
            except Exception:
                if attempt == retries:
                    raise
                self.reconstruct()

    def reconstruct(self, rebuild_passes: bool = False) -> None:
        """Construct the pipeline again, keeping the persistent state: it
        is copied to the host first and uploaded into the fresh state where
        the resource keeps its shape. ``rebuild_passes`` makes new pass
        instances from this module's (possibly reloaded) code first."""
        persistent = set(self.pipeline.registry.persistent_names)
        host = {k: v.cpu().clone() if isinstance(v, torch.Tensor) else v
                for k, v in self.state.items() if k in persistent}
        if rebuild_passes:
            module = importlib.import_module(__name__)
            self.pipeline = module.make_forward_pipeline(self.cfg, device=self.device,
                                                         **self._pipeline_kw)
        self.pipeline.scene_animator = self.scene_animator
        self.pipeline.construct_all()
        fresh = self.pipeline.initial_state()
        for k, v in host.items():
            if k not in fresh:
                continue
            if not isinstance(v, torch.Tensor):
                fresh[k] = v
            elif tuple(fresh[k].shape) == tuple(v.shape):
                fresh[k] = v.to(self.device)
        self.state = fresh

    def save_checkpoint(self, path: str) -> None:
        """Write the resumable state to ``path`` (npz): ``__meta__`` (frame
        index, time, exposure compensation, float64) and ``state.<name>``
        for each persistent resource (TAA history, DDGI atlases, the
        reflection history, the cached sun map and its version), the
        reference's layout."""
        persist = {}
        for k in self.pipeline.registry.persistent_names:
            if k in self.state:
                v = self.state[k]
                persist[f"state.{k}"] = v.cpu().numpy() if isinstance(v, torch.Tensor) \
                    else np.asarray(v)
        np.savez_compressed(
            path,
            __meta__=np.array([self.frame_index, self.time,
                               self.camera.exposure_compensation], np.float64),
            **persist,
        )

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of either package: the frame index, time
        and exposure compensation, and each persistent resource it holds
        (host values as Python ints, tensors in this pipeline's dtype on
        this renderer's device)."""
        reg = self.pipeline.registry
        with np.load(path) as z:
            meta = z["__meta__"]
            self.frame_index = int(meta[0])
            self.time = float(meta[1])
            self.camera.exposure_compensation = float(meta[2])
            for k in reg.persistent_names:
                key = f"state.{k}"
                if key not in z:
                    continue
                dtype = reg.desc(k).dtype
                if dtype is None:
                    self.state[k] = int(z[key])
                else:
                    self.state[k] = torch.from_numpy(np.array(z[key])).to(self.device, dtype)

    def pick(self, x: int, y: int) -> dict:
        """What lies under pixel (x, y) of the last frame: the instance,
        the scene triangle (the setup row's original triangle: near-clipped
        pieces map back), the reverse-Z depth and the view distance near /
        depth (None, and -1 ids, on the sky)."""
        vis = int(self.state["Visibility"][y, x])
        depth = float(self.state["SceneDepth"][y, x])
        if vis < 0:
            return {"instance": -1, "triangle": -1, "depth": depth, "distance": None}
        tri = int(self.state["vis.setup"].orig_tri[vis])
        inst = int(self.scene_arrays.tri_instance[tri])
        distance = self.camera.near / max(depth, 1e-8)
        return {"instance": inst, "triangle": tri, "depth": depth, "distance": distance}

    def upload_animation(self) -> None:
        """Evaluate the scene's animations at ``time`` on the host and copy
        the palette and the morph weights into the scene's tensors, which
        keep their storage."""
        palette = self.scene.update_animations(self.time)
        sa = self.scene_arrays
        sa.palette.copy_(torch.from_numpy(palette.copy()))
        for dst, w in zip(sa.morph_weights, self.scene.morph_weights(), strict=True):
            dst.copy_(torch.from_numpy(w.copy()))

    def render_frames(self, n: int) -> torch.Tensor:
        for _ in range(n):
            out = self.render_frame()
        return out

    def benchmark(self, warmup: int = 3, iters: int = 10, before_frame=None,
                  eager: bool = False, pass_frames: int = 3) -> dict:
        """Time ``iters`` frames after ``warmup`` on the card: each frame's ms
        and their median (CUDA events around the frame, so the host's gaps
        between launches count), and the host's wall-clock ms per frame. The
        frames are the captured ones where the pipeline captures, unless
        ``eager``. Then ``pass_frames`` more frames run eagerly with an event
        pair around every pass: their median ms of every pass is
        ``eager_pass_ms``; and, where the pipeline captures, ``pass_frames``
        frames replay as the chain of per-pass graphs with an event between
        each two passes: their median ms of every pass is ``pass_ms`` (the
        eager table where it does not capture; ``pass_ms_from`` says
        which). ``before_frame(frame_index)`` runs before each frame,
        untimed by the events: a bench moves the camera there."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the card; the renderer is on " + str(self.device))

        def step(**kw):
            if before_frame is not None:
                before_frame(self.frame_index)
            self.render_frame(**kw)

        with eager_frames() if eager else contextlib.nullcontext():
            for _ in range(warmup):
                step()
            frames = []
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                end.record()
                frames.append((start, end))
            torch.cuda.synchronize(self.device)
            wall_ms = (time.perf_counter() - t0) * 1e3 / max(iters, 1)
        frame_ms = [s.elapsed_time(e) for s, e in frames]

        def pass_table() -> dict:
            per: dict = {}
            for _ in range(pass_frames):
                events: list = []
                step(pass_events=events)
                torch.cuda.synchronize(self.device)
                for name, s, e in events:
                    per.setdefault(name, []).append(s.elapsed_time(e))
            return {k: statistics.median(v) for k, v in per.items()}

        with eager_frames():
            eager_pass = pass_table()
        chain = self.pipeline.captured
        return {
            "ms_per_frame": statistics.median(frame_ms),
            "wall_ms_per_frame": wall_ms,
            "frame_ms": frame_ms,
            "captured": self.pipeline.captured and not eager,
            "eager_pass_ms": eager_pass,
            "pass_ms": pass_table() if chain else eager_pass,
            "pass_ms_from": "captured per-pass graphs" if chain else "eager frames",
        }
