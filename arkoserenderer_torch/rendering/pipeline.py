"""RenderPipeline: the pass list and its frame function (port of
arkoserenderer_tpu/rendering/pipeline.py).

Two phases, as in the reference:

  * ``construct_all()`` — every pass declares its resources against a fresh
    Registry and returns its execute callback;
  * ``frame_fn()``      — runs the callbacks eagerly, in declared order, on
    the frame-state dict (the reference jits this whole function; capturing
    it in a CUDA graph is later work).

``FrameContext`` bundles what every execute callback receives: the scene
tensors, the camera state and the frame index (a host int).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.core.types import RasterConfig, SceneLimits
from arkoserenderer_torch.rendering.registry import Registry
from arkoserenderer_torch.scene.camera import CameraState
from arkoserenderer_torch.scene.scene import SceneArrays, SceneStatic


class FrameContext(NamedTuple):
    scene: SceneArrays
    camera: CameraState
    frame_index: int
    delta_time: float


@dataclasses.dataclass
class PipelineConfig:
    """Static configuration shared by all passes."""

    width: int = 1920
    height: int = 1080
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    limits: SceneLimits = dataclasses.field(default_factory=SceneLimits)
    shadow_map_size: int = 2048
    local_shadow_map_size: int = 512  # each spot light's shadow map
    tonemap_mode: str = "agx"  # a key of ops.tonemap.MODES
    # TAA history filter: "catmull" (16-tap Catmull-Rom, sharp history) or
    # "bilinear" (4 taps).
    taa_filter: str = "catmull"
    scene: SceneStatic = dataclasses.field(default_factory=SceneStatic)


ExecuteFn = Callable[[dict, FrameContext], dict]


class RenderPass(abc.ABC):
    """Base pass (RenderPipelineNode analogue)."""

    name: str = "UnnamedPass"

    @abc.abstractmethod
    def construct(self, cfg: PipelineConfig, reg: Registry,
                  device: torch.device) -> ExecuteFn:
        """Declare resources against ``reg``; return the execute callback.
        Constants the pass keeps live on ``device``."""


class RenderPipeline:
    def __init__(self, cfg: PipelineConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.passes: list[RenderPass] = []
        self.registry = Registry()
        self._executes: list[tuple[str, ExecuteFn]] | None = None

    def add_pass(self, p: RenderPass) -> "RenderPipeline":
        self.passes.append(p)
        return self

    def construct_all(self):
        """Run every pass's construct against a fresh Registry."""
        self.registry = Registry()
        self._executes = []
        for p in self.passes:
            self.registry.set_current_node(p.name)
            self._executes.append((p.name, p.construct(self.cfg, self.registry, self.device)))
        self.registry.set_current_node(None)
        return self

    def _require_constructed(self):
        if self._executes is None:
            raise RuntimeError("call construct_all() first")

    def initial_state(self) -> dict:
        self._require_constructed()
        return self.registry.initial_state(self.device)

    def frame_fn(self, state: dict, scene: SceneArrays, camera: CameraState,
                 frame_index: int, delta_time: float = 1 / 60,
                 pass_events: list | None = None) -> dict:
        """Run all passes in declared order; returns the new state dict.

        ``pass_events``: when a list, each pass appends (name, start, end)
        CUDA events recorded around it, for a per-pass time table."""
        self._require_constructed()
        ctx = FrameContext(scene=scene, camera=camera,
                           frame_index=int(frame_index), delta_time=float(delta_time))
        state = dict(state)
        for name, execute in self._executes:
            if pass_events is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            updates = execute(state, ctx)
            if pass_events is not None:
                end.record()
                pass_events.append((name, start, end))
            if updates:
                state.update(updates)
        return state


def pixel_centers(cfg: PipelineConfig, device):
    """(N,) px / (N,) py flattened pixel-centre coordinates on ``device``."""
    xs = np.arange(cfg.width, dtype=np.float32) + 0.5
    ys = np.arange(cfg.height, dtype=np.float32) + 0.5
    px, py = np.meshgrid(xs, ys)
    return (torch.from_numpy(px.ravel()).to(device),
            torch.from_numpy(py.ravel()).to(device))
