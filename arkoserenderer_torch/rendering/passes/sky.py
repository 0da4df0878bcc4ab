"""Sky pass (port of arkoserenderer_tpu/rendering/passes/sky.py at
``sky_fetch_scale=1``): environment map where no geometry covered the
pixel, and the camera-reprojection sky velocity. Each pixel is its own
fetch, so a band needs no halo; the reference exchanges one only for the
reduced-rate fetch (``sky_fetch_scale > 1``), which is not ported."""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.shading import shade_sky
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    frame_rows,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class SkyPass(RenderPass):
    name = "SkyView"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        reg.get("SceneColor")
        reg.get("SceneCoverage")
        reg.get("SceneVelocity")
        px, py = pixel_centers(cfg, device)

        def execute(state: dict, ctx: FrameContext) -> dict:
            valid = state["SceneCoverage"].reshape(-1)
            out, sky_vel = shade_sky(
                ctx.scene, ctx.camera, state["SceneColor"].reshape(-1, 3), valid,
                px, frame_rows(py, ctx), w, full_h,
            )
            vel = torch.where(valid[:, None], state["SceneVelocity"].reshape(-1, 2), sky_vel)
            return {"SceneColor": out.reshape(h, w, 3), "SceneVelocity": vel.reshape(h, w, 2)}

        return execute
