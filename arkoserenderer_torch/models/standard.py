"""Standard pipeline assembly and the frame loop (port of
arkoserenderer_tpu/models/standard.py, the raster frames).

The pass order is the reference's: Scene -> Geometry -> SunShadow ->
[LocalShadow] -> VisibilityShading -> [SSAO] -> LightingCompose -> SkyView ->
[Fog] -> [MotionBlur] -> [DepthOfField] -> [Bloom] -> [TAA] -> Output ->
[FXAA] -> [CAS]. Ray tracing, DDGI, subsurface scattering, translucency,
upscaling and the debug overlays are later slices; asking for one raises
``NotImplementedError`` naming the flag.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

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
    VisibilityShadingPass,
)
from arkoserenderer_torch.rendering.pipeline import PipelineConfig, RenderPipeline
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.scene import Scene

# Flags of the reference's make_forward_pipeline whose passes are not ported
# yet, with the value that leaves each one off.
UNPORTED_FLAGS = {
    "rt_shadows": False, "rt_reflections": False, "ddgi": None, "ddgi_probe_debug": False,
    "light_icons": False, "ssss": False, "rt_refit": False, "oit_layers": 1,
    "upscale_to": None, "upscale_mode": "temporal", "debug_draw": None,
}


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
    film_grain: float = 0.0,
    vignette: float = 0.18,  # 0 disables
    device="cuda",
    **later,
) -> RenderPipeline:
    """The raster backbone; passes run in the order they are added. The
    flags keep the reference's names and defaults."""
    for name, value in later.items():
        if name not in UNPORTED_FLAGS:
            raise TypeError(f"make_forward_pipeline() got an unexpected keyword argument {name!r}")
        if value != UNPORTED_FLAGS[name]:
            raise NotImplementedError(f"{name} is not ported yet")
    pipe = RenderPipeline(cfg, device=device)
    pipe.add_pass(ScenePass())
    pipe.add_pass(GeometryPass())
    if shadows:
        pipe.add_pass(SunShadowPass())
        if any(cfg.scene.spot_shadow_casters) and cfg.scene.n_spots > 0:
            pipe.add_pass(LocalShadowPass())
    pipe.add_pass(VisibilityShadingPass())
    if ssao:
        pipe.add_pass(SSAOPass())
    pipe.add_pass(LightingComposePass())
    pipe.add_pass(SkyPass())
    if fog:
        pipe.add_pass(FogPass())
    if motion_blur:
        pipe.add_pass(MotionBlurPass())
    if depth_of_field:
        pipe.add_pass(DepthOfFieldPass())
    if bloom:
        pipe.add_pass(BloomPass())
    if taa:
        pipe.add_pass(TAAPass())
    pipe.add_pass(OutputPass(film_grain_gain=film_grain, vignette_intensity=vignette))
    if fxaa:
        pipe.add_pass(FXAAPass())
    if cas:
        pipe.add_pass(CASPass())
    pipe.construct_all()
    return pipe


class Renderer:
    """Host frame loop: owns the pipeline, the persistent frame state and
    the camera's previous-frame bookkeeping. Nothing is read back from the
    device per frame. It runs on the card unless ``device`` asks for the CPU;
    without a card the default raises, as torch does."""

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
                 device="cuda", **pipeline_kw):
        self.device = torch.device(device)
        self.scene = scene
        self.camera = camera
        self.cfg = dataclasses.replace(cfg, scene=scene.static_info())
        self.pipeline = make_forward_pipeline(self.cfg, device=self.device, **pipeline_kw)
        self.scene_arrays = scene.build(self.device)
        self.state = self.pipeline.initial_state()
        self.frame_index = 0

    def render_frame(self, delta_time: float = 1 / 60,
                     pass_events: list | None = None) -> torch.Tensor:
        """Render one frame; returns the (H, W, 3) LDR image on the device."""
        persistent = self.pipeline.registry.persistent_names
        inputs = {k: self.state[k] for k in persistent if k in self.state}
        if "scene.version" in persistent:
            inputs["scene.version"] = self._scene_version
        cam_state = self.camera.state(self.frame_index, self.device)
        self.state = self.pipeline.frame_fn(
            inputs, self.scene_arrays, cam_state, self.frame_index, delta_time,
            pass_events=pass_events,
        )
        self.camera.post_render()
        self.frame_index += 1
        return self.state["LDR"]

    def render_frames(self, n: int) -> torch.Tensor:
        for _ in range(n):
            out = self.render_frame()
        return out

    def benchmark(self, warmup: int = 3, iters: int = 10, before_frame=None) -> dict:
        """Time ``iters`` frames after ``warmup`` on the card: each frame's ms
        and their median (CUDA events around the frame, so the host's gaps
        between launches count), the host's wall-clock ms per frame, and
        the median ms of every pass. ``before_frame(frame_index)`` runs
        before each frame, untimed by the events: a bench moves the camera
        there."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the card; the renderer is on " + str(self.device))

        def step(**kw):
            if before_frame is not None:
                before_frame(self.frame_index)
            self.render_frame(**kw)

        for _ in range(warmup):
            step()
        frames, passes = [], []
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            events: list = []
            start.record()
            step(pass_events=events)
            end.record()
            frames.append((start, end))
            passes.append(events)
        torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / max(iters, 1)
        frame_ms = [s.elapsed_time(e) for s, e in frames]
        pass_ms = {}
        for events in passes:
            for name, s, e in events:
                pass_ms.setdefault(name, []).append(s.elapsed_time(e))
        return {
            "ms_per_frame": statistics.median(frame_ms),
            "wall_ms_per_frame": wall_ms,
            "frame_ms": frame_ms,
            "pass_ms": {k: statistics.median(v) for k, v in pass_ms.items()},
        }
