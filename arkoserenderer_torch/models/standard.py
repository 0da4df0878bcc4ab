"""Standard pipeline assembly and the frame loop (port of
arkoserenderer_tpu/models/standard.py, the forward slice).

The forward frame: Scene -> Geometry -> SunShadow -> VisibilityShading ->
LightingCompose -> SkyView -> Output. TAA and Bloom are the next slice;
asking for them raises.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from arkoserenderer_torch.rendering.passes import (
    GeometryPass,
    LightingComposePass,
    OutputPass,
    ScenePass,
    SkyPass,
    SunShadowPass,
    VisibilityShadingPass,
)
from arkoserenderer_torch.rendering.pipeline import PipelineConfig, RenderPipeline
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.scene import Scene


def make_forward_pipeline(
    cfg: PipelineConfig,
    *,
    taa: bool = True,
    bloom: bool = True,
    shadows: bool = True,
    vignette: float = 0.18,  # 0 disables
    device="cuda",
) -> RenderPipeline:
    """The raster backbone of the forward frame; passes run in this order.
    ``taa`` and ``bloom`` keep the reference's defaults and must be False
    until those passes are ported."""
    if taa or bloom:
        raise NotImplementedError("TAA and Bloom are not ported yet: pass taa=False, bloom=False")
    pipe = RenderPipeline(cfg, device=device)
    pipe.add_pass(ScenePass())
    pipe.add_pass(GeometryPass())
    if shadows:
        pipe.add_pass(SunShadowPass())
    pipe.add_pass(VisibilityShadingPass())
    pipe.add_pass(LightingComposePass())
    pipe.add_pass(SkyPass())
    pipe.add_pass(OutputPass(vignette_intensity=vignette))
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

    def benchmark(self, warmup: int = 3, iters: int = 10) -> dict:
        """Device time per frame with CUDA events: median ms/frame over
        ``iters`` frames after ``warmup``, each frame's ms, and the median
        ms of every pass."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the card; the renderer is on " + str(self.device))
        for _ in range(warmup):
            self.render_frame()
        frames, passes = [], []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            events: list = []
            start.record()
            self.render_frame(pass_events=events)
            end.record()
            frames.append((start, end))
            passes.append(events)
        torch.cuda.synchronize(self.device)
        frame_ms = [s.elapsed_time(e) for s, e in frames]
        pass_ms = {}
        for events in passes:
            for name, s, e in events:
                pass_ms.setdefault(name, []).append(s.elapsed_time(e))
        return {
            "ms_per_frame": statistics.median(frame_ms),
            "frame_ms": frame_ms,
            "pass_ms": {k: statistics.median(v) for k, v in pass_ms.items()},
        }
