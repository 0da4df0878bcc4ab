"""Upscale passes: the render-resolution LDR image to display resolution
(port of arkoserenderer_tpu/rendering/passes/upscale.py). The pipeline
renders at ``cfg.width`` x ``cfg.height``; these passes publish LDRDisplay.

TemporalUpscale
---------------
Temporal super-resolution, the default: each frame's jittered render is
resampled to display resolution with jitter-compensated weights
(``ops/image.resize_bilinear_rational_jittered``), and blended into a
persistent display-resolution history, reprojected along the upsampled
motion vectors and clamped to mean +/- gamma * sigma of the current 3x3
neighbourhood (gamma grows from 1 to 4 as the pixel comes to rest). TAA is
left out of such a pipeline: the jitter must reach the accumulator.

The history is reprojected as the reference reprojects it: with nine
sub-pixel shifts (``ops/image.bilinear_sample_small_offset``) when the
frame's largest display-space speed, sqrt(vx^2 + vy^2), is at most a pixel,
with the bilinear gather otherwise. Both are formed and ``torch.where``
takes one by the predicate, computed on the device, so the host reads
nothing.

Publishes LDRDisplay (dh, dw, 3) and the persistent UpscaleHistory.

Upscale
-------
The spatial form: bilinear resample and adaptive sharpening
(``ops/upscale.upscale``). Publishes LDRDisplay.
"""

from __future__ import annotations

import dataclasses

import torch

from arkoserenderer_torch.ops.image import (
    bilinear_sample,
    bilinear_sample_small_offset,
    resize_bilinear_rational,
    resize_bilinear_rational_jittered,
    shift_img,
)
from arkoserenderer_torch.ops.postprocess import cas
from arkoserenderer_torch.ops.upscale import upscale
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class TemporalUpscalePass(RenderPass):
    name = "TemporalUpscale"

    def __init__(self, display_width: int, display_height: int,
                 hysteresis: float = 0.9, sharpness: float = 0.25):
        self.display = (display_width, display_height)
        self.hysteresis = hysteresis
        self.sharpness = sharpness

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        rh, rw = cfg.height, cfg.width
        dw, dh = self.display
        reg.get("LDR")
        reg.get("SceneVelocity")
        reg.create("UpscaleHistory", (dh, dw, 3), torch.float32, persistent=True)
        reg.create("LDRDisplay", (dh, dw, 3), torch.float32)
        scale = torch.tensor([dw / rw, dh / rh], dtype=torch.float32, device=device)
        px, py = pixel_centers(dataclasses.replace(cfg, width=dw, height=dh), device)
        hysteresis, sharp = self.hysteresis, self.sharpness

        def execute(state: dict, ctx: FrameContext) -> dict:
            history = state["UpscaleHistory"]
            jitter = ctx.camera.jitter_px
            cur = resize_bilinear_rational_jittered(state["LDR"], dh, dw, jitter[0], jitter[1])
            vel = resize_bilinear_rational(state["SceneVelocity"], dh, dw) * scale
            speed = torch.sqrt(torch.sum(vel * vel, dim=-1, keepdim=True))
            prev_x = px - vel[..., 0].reshape(-1)
            prev_y = py - vel[..., 1].reshape(-1)
            gathered = bilinear_sample(history, prev_x, prev_y).reshape(dh, dw, 3)
            shifted = bilinear_sample_small_offset(history, -vel[..., 0], -vel[..., 1])
            hist = torch.where(speed.max() <= 1.0, shifted, gathered)

            m1 = torch.zeros_like(cur)
            m2 = torch.zeros_like(cur)
            for oy in (-1, 0, 1):
                for ox in (-1, 0, 1):
                    s = shift_img(cur, oy, ox)
                    m1 = m1 + s
                    m2 = m2 + s * s
            m1 = m1 / 9.0
            sigma = torch.sqrt(torch.clamp(m2 / 9.0 - m1 * m1, min=0.0))
            gamma = 1.0 + 3.0 * torch.exp(-8.0 * speed)  # ~4 at rest, ~1 in motion
            hist = torch.minimum(torch.maximum(hist, m1 - gamma * sigma), m1 + gamma * sigma)

            on_screen = ((prev_x >= 0.0) & (prev_x < dw) & (prev_y >= 0.0)
                         & (prev_y < dh)).reshape(dh, dw, 1)
            alpha = torch.where((ctx.frame_index == 0) | ~on_screen, 1.0, 1.0 - hysteresis)
            out = hist + (cur - hist) * alpha
            disp = cas(torch.clamp(out, 0.0, 1.0), sharp) if sharp > 0.0 else out
            return {"LDRDisplay": torch.clamp(disp, 0.0, 1.0), "UpscaleHistory": out}

        return execute


class UpscalePass(RenderPass):
    name = "Upscale"

    def __init__(self, display_width: int, display_height: int, sharpness: float = 0.4):
        self.display = (display_width, display_height)
        self.sharpness = sharpness

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("LDR")
        dw, dh = self.display
        reg.create("LDRDisplay", (dh, dw, 3), torch.float32)
        sharp = self.sharpness

        def execute(state: dict, ctx: FrameContext) -> dict:
            return {"LDRDisplay": upscale(state["LDR"], dh, dw, sharp)}

        return execute
