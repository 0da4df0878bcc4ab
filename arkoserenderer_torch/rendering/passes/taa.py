"""Temporal anti-aliasing (port of arkoserenderer_tpu/rendering/passes/taa.py).

The camera jitters its projection with a Halton sequence; this pass
reprojects the persistent history image along the per-pixel motion vectors,
clamps it to the 3x3 neighbourhood of the current frame (an AABB in RGB) and
blends exponentially. Where the reprojection leaves the screen, and on the
first frame, the current frame is taken wholesale; the first frame is a
branch on the host's frame index.

The history is resampled with Catmull-Rom (``taa_filter="catmull"``, the
default) or bilinearly; the reference's sub-pixel shortcut for the bilinear
filter, which branches on the largest velocity of the frame, is not ported.

Publishes SceneColor and the persistent TAAHistory (H, W, 3).
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.image import (
    bilinear_sample,
    neighborhood_min_max,
    sample_catmull_rom,
)
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class TAAPass(RenderPass):
    name = "TAA"

    def __init__(self, hysteresis: float = 0.9):
        self.hysteresis = hysteresis

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneVelocity")
        reg.create("TAAHistory", (h, w, 3), torch.float32, persistent=True)
        if cfg.taa_filter not in ("catmull", "bilinear"):
            raise ValueError(f"unknown taa_filter {cfg.taa_filter!r}")
        px, py = pixel_centers(cfg, device)
        hysteresis = self.hysteresis
        resample = sample_catmull_rom if cfg.taa_filter == "catmull" else bilinear_sample

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            velocity = state["SceneVelocity"].reshape(-1, 2)
            prev_x = px - velocity[:, 0]
            prev_y = py - velocity[:, 1]
            hist = resample(state["TAAHistory"], prev_x, prev_y).reshape(h, w, 3)
            lo, hi = neighborhood_min_max(color)
            hist = torch.clamp(hist, lo, hi)
            if ctx.frame_index == 0:
                out = hist + (color - hist)
            else:
                on_screen = ((prev_x >= 0.0) & (prev_x < w) & (prev_y >= 0.0)
                             & (prev_y < h)).reshape(h, w, 1)
                out = hist + (color - hist) * torch.where(on_screen, 1.0 - hysteresis, 1.0)
            return {"SceneColor": out, "TAAHistory": out}

        return execute
