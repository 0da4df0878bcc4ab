"""DDGI probe overlay (port of
arkoserenderer_tpu/rendering/passes/ddgi_debug.py): each probe of the grid
is splatted as a small disc coloured by its mean irradiance (times
``exposure_boost``, clamped to 1) over LDR, hidden behind the scene's
depth unless ``xray``. Shared pixels go to the later disc pixel, then the
later probe, as the reference's in-order scatter leaves them.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops import ddgi as ddgi_ops
from arkoserenderer_torch.rendering.passes.overlay import disc_offsets, project, splat
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


class DDGIProbeDebugPass(RenderPass):
    name = "DDGIProbeDebug"

    def __init__(self, grid: ddgi_ops.ProbeGridConfig, radius_px: int = 3,
                 exposure_boost: float = 4.0, xray: bool = False):
        self.grid = grid
        self.radius_px = radius_px
        self.exposure_boost = exposure_boost
        self.xray = xray

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("LDR")
        reg.get("SceneDepth")
        reg.get("DDGI.irradiance")
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        positions = torch.from_numpy(ddgi_ops.probe_positions(self.grid)).to(device)
        offs = disc_offsets(self.radius_px)
        boost, xray = self.exposure_boost, self.xray

        def execute(state: dict, ctx: FrameContext) -> dict:
            irr = state["DDGI.irradiance"].mean(dim=(1, 2))  # (P, 3)
            xi, yi, d, ok = project(ctx.camera.view_proj, positions, w, full_h, ctx.row_offset)
            color = torch.clamp(irr * boost, 0.0, 1.0)
            return {"LDR": splat(state["LDR"], state["SceneDepth"], xi, yi, d, ok, color, offs,
                                 depth_test=not xray)}

        return execute
