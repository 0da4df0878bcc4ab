"""Light icon billboards (port of
arkoserenderer_tpu/rendering/passes/icons.py): each spot and point light
is splatted as a small camera-facing bulb (a filled disc and a stem below)
tinted by its colour's chromaticity, over LDR, hidden behind the scene's
depth unless ``xray``. Shared pixels go to the later sprite pixel, then the
later light, as the reference's in-order scatter leaves them.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.rendering.passes.overlay import disc_offsets, project, splat
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


def _bulb_offsets(r: int) -> list[tuple[int, int]]:
    """The bulb sprite: a filled disc of radius ``r`` and a stem below."""
    return disc_offsets(r) + [(r + 1, 0), (r + 2, 0), (r + 1, -1), (r + 1, 1)]


class IconBillboardPass(RenderPass):
    name = "IconBillboards"

    def __init__(self, radius_px: int = 3, xray: bool = False):
        self.radius_px = radius_px
        self.xray = xray

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("LDR")
        reg.get("SceneDepth")
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        n_spots, n_points = cfg.scene.n_spots, cfg.scene.n_points
        offs = _bulb_offsets(self.radius_px)
        xray = self.xray

        def execute(state: dict, ctx: FrameContext) -> dict:
            if n_spots + n_points == 0:
                return {}
            lt = ctx.scene.lights
            pos = torch.cat([lt.spot_pos[:n_spots], lt.point_pos[:n_points]])
            col = torch.cat([lt.spot_color[:n_spots], lt.point_color[:n_points]])
            tint = col / torch.clamp(col.max(dim=-1, keepdim=True).values, min=1e-6)
            xi, yi, d, ok = project(ctx.camera.view_proj, pos, w, full_h, ctx.row_offset)
            return {"LDR": splat(state["LDR"], state["SceneDepth"], xi, yi, d, ok, tint, offs,
                                 depth_test=not xray)}

        return execute
