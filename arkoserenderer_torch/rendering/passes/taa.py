"""Temporal anti-aliasing (port of arkoserenderer_tpu/rendering/passes/taa.py).

The camera jitters its projection with a Halton sequence; this pass
reprojects the persistent history image along the per-pixel motion vectors,
clamps it to the 3x3 neighbourhood of the current frame (an AABB in RGB) and
blends exponentially. Where the reprojection leaves the screen, and on the
first frame, the current frame is taken wholesale: a ``torch.where`` on
the frame index, a device scalar, at the reference's place.

The history is resampled with Catmull-Rom (``taa_filter="catmull"``, the
default; ``use_catmull_rom`` overrides the config) or bilinearly. Under the
bilinear filter a frame whose largest velocity component is at most a pixel
resamples with nine weighted static shifts
(``ops/image.bilinear_sample_small_offset``) and any other frame with the
gathering ``bilinear_sample``, as the reference branches. The two round in
different orders (up to ~2e-5 apart), so the branch is the reference's:
both are formed and ``torch.where`` takes one by the predicate, computed on
the device, so no frame waits on a readback.

Publishes SceneColor and the persistent TAAHistory (H, W, 3).
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.image import (
    bilinear_sample,
    bilinear_sample_small_offset,
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

    def __init__(self, hysteresis: float = 0.9, use_catmull_rom: bool | None = None):
        self.hysteresis = hysteresis
        self.use_catmull_rom = use_catmull_rom  # None: follow cfg.taa_filter

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneVelocity")
        reg.create("TAAHistory", (h, w, 3), torch.float32, persistent=True)
        if cfg.taa_filter not in ("catmull", "bilinear"):
            raise ValueError(f"unknown taa_filter {cfg.taa_filter!r}")
        px, py = pixel_centers(cfg, device)
        hysteresis = self.hysteresis
        catmull = (self.use_catmull_rom if self.use_catmull_rom is not None
                   else cfg.taa_filter == "catmull")

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            history = state["TAAHistory"]
            vel_img = state["SceneVelocity"]
            velocity = vel_img.reshape(-1, 2)
            prev_x = px - velocity[:, 0]
            prev_y = py - velocity[:, 1]
            if catmull:
                hist = sample_catmull_rom(history, prev_x, prev_y).reshape(h, w, 3)
            else:
                gathered = bilinear_sample(history, prev_x, prev_y).reshape(h, w, 3)
                shifted = bilinear_sample_small_offset(history, -vel_img[..., 0],
                                                       -vel_img[..., 1])
                hist = torch.where(vel_img.abs().max() <= 1.0, shifted, gathered)
            lo, hi = neighborhood_min_max(color)
            hist = torch.clamp(hist, lo, hi)
            # History is invalid where reprojection left the screen, and on
            # the first frame (the frame index is a device scalar).
            on_screen = ((prev_x >= 0.0) & (prev_x < w) & (prev_y >= 0.0)
                         & (prev_y < h)).reshape(h, w, 1)
            alpha = torch.where((ctx.frame_index == 0) | ~on_screen, 1.0, 1.0 - hysteresis)
            out = hist + (color - hist) * alpha
            return {"SceneColor": out, "TAAHistory": out}

        return execute
