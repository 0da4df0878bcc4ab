"""Sky pass (port of arkoserenderer_tpu/rendering/passes/sky.py):
environment map where no geometry covered the pixel, and the
camera-reprojection sky velocity.

At ``sky_fetch_scale`` k > 1 (when k divides both sides of the band) the
env map is fetched at the centres of k x k blocks, ((i + 0.5) * k), and
bilinearly upsampled (``ops/image.upsample_bilinear_k``); the velocity
stays full rate. A full-rate band needs no halo, each pixel being its own
fetch; a low-rate band takes the neighbouring bands' boundary rows of the
low-rate image (``band_halo_rows``) for its upsample, so its seams match
the whole frame's.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.ops.envmap import sample_equirect
from arkoserenderer_torch.ops.image import band_halo_rows, upsample_bilinear_k
from arkoserenderer_torch.ops.shading import shade_sky
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    frame_rows,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


def _directions(cam, px, py, width: int, height: int) -> torch.Tensor:
    """Unit camera-ray directions through the unjittered pixel positions."""
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = (0.5 - py / height) * 2.0
    inv_vp = torch.linalg.inv_ex(cam.unjittered_view_proj).inverse
    lanes = [ndc_x * inv_vp[r, 0] + ndc_y * inv_vp[r, 1] + 0.5 * inv_vp[r, 2] + inv_vp[r, 3]
             for r in range(4)]
    den = lanes[3]
    inv = torch.where(torch.abs(den) > 1e-10, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    world = torch.stack(lanes[:3], dim=-1)
    return mx.normalize(world * inv[:, None] - cam.position[None, :])


class SkyPass(RenderPass):
    name = "SkyView"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        reg.get("SceneColor")
        reg.get("SceneCoverage")
        reg.get("SceneVelocity")
        px, py = pixel_centers(cfg, device)
        k = cfg.sky_fetch_scale
        lowres = k > 1 and h % k == 0 and w % k == 0
        if lowres:
            xs = (torch.arange(w // k, dtype=torch.float32, device=device) + 0.5) * k
            ys = (torch.arange(h // k, dtype=torch.float32, device=device) + 0.5) * k
            py_lo, px_lo = (g.reshape(-1) for g in torch.meshgrid(ys, xs, indexing="ij"))

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"].reshape(-1, 3)
            valid = state["SceneCoverage"].reshape(-1)
            py_g = frame_rows(py, ctx)
            if lowres:
                cam = ctx.camera
                dirs = _directions(cam, px_lo, frame_rows(py_lo, ctx), w, full_h)
                sky_lo = (sample_equirect(ctx.scene.env_map, dirs) * ctx.scene.env_brightness
                          * cam.exposure).reshape(h // k, w // k, 3)
                halo = None if ctx.band is None else band_halo_rows(sky_lo, ctx.band)
                sky = upsample_bilinear_k(sky_lo, k, halo_rows=halo).reshape(-1, 3)
                far_point = cam.position[None, :] + _directions(cam, px, py_g, w, full_h) * 1e4
                pcx, pcy, pw = mx.transform_point_lanes(cam.prev_view_proj, far_point,
                                                        rows=(0, 1, 3))
                inv_pw = torch.where(torch.abs(pw) > 1e-8,
                                     1.0 / torch.where(pw == 0, 1.0, pw), 0.0)
                prev_sx = (pcx * inv_pw * 0.5 + 0.5) * w
                prev_sy = (0.5 - pcy * inv_pw * 0.5) * full_h
                sky_vel = torch.stack([px - prev_sx, py_g - prev_sy], dim=-1)
                out = torch.where(valid[:, None], color, sky)
            else:
                out, sky_vel = shade_sky(ctx.scene, ctx.camera, color, valid, px, py_g, w,
                                         full_h)
            vel = torch.where(valid[:, None], state["SceneVelocity"].reshape(-1, 2), sky_vel)
            return {"SceneColor": out.reshape(h, w, 3), "SceneVelocity": vel.reshape(h, w, 2)}

        return execute
