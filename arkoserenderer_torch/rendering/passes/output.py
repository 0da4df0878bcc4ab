"""Output pass: tonemap, vignette, film grain, sRGB encode and the optional
3D colour-grade LUT on the display-encoded values (port of
arkoserenderer_tpu/rendering/passes/output.py). SceneColor is already
pre-exposed. Also meters the average log-luminance (Metering.avgLum) on
the device."""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.assets.external import apply_lut3d
from arkoserenderer_torch.ops import tonemap as tm
from arkoserenderer_torch.ops.texture import linear_to_srgb
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    frame_rows,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class OutputPass(RenderPass):
    name = "Output"

    def __init__(self, mode: str | None = None, vignette_intensity: float = 0.18,
                 film_grain_gain: float = 0.0, color_grade_lut=None):
        """``mode`` is a key of ``ops.tonemap.MODES``, or None for the
        config's ``tonemap_mode``; ``color_grade_lut`` an
        ``assets.external.CubeLUT``."""
        self.mode = mode
        self.color_grade_lut = color_grade_lut
        self.vignette_intensity = vignette_intensity
        self.film_grain_gain = film_grain_gain

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        reg.get("SceneColor")
        reg.create("LDR", (h, w, 3), torch.float32)
        reg.create("Metering.avgLum", (), torch.float32)
        mode = tm.MODES[self.mode or cfg.tonemap_mode]
        vign = self.vignette_intensity
        grain = self.film_grain_gain
        px, py = pixel_centers(cfg, device)
        xpx = px.reshape(h, w)
        lut = None
        if self.color_grade_lut is not None:
            lut = torch.from_numpy(np.asarray(self.color_grade_lut.table, np.float32)).to(device)

        def execute(state: dict, ctx: FrameContext) -> dict:
            c = torch.clamp(state["SceneColor"], min=0.0)
            luma = 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]
            avg_log_lum = torch.exp(torch.mean(torch.log(luma + 1e-4)))
            c = tm.tonemap(c, mode)
            ypx = frame_rows(py, ctx).reshape(h, w)  # vignette and grain in frame rows
            if vign > 0.0:
                c = tm.vignette(c, torch.stack([xpx / w, ypx / full_h], dim=-1), vign)
            if grain > 0.0:
                c = tm.film_grain(c, torch.stack([xpx, ypx], dim=-1), ctx.frame_index, grain)
            out = torch.clamp(linear_to_srgb(c), 0.0, 1.0)
            if lut is not None:
                out = apply_lut3d(lut, out)
            return {"LDR": out, "Metering.avgLum": avg_log_lum}

        return execute
