"""Screen-space subsurface scattering (port of
arkoserenderer_tpu/rendering/passes/ssss.py, the dense branch).

Burley diffusion-profile taps on a Fibonacci disc, blended into the pixels
of subsurface materials (SceneMaterial's subsurface channel), with
depth-aware tap rejection. The world-space scattering radius maps to pixels
through the projection, so the blur shrinks with distance. Every tap is one
bilinear fetch of colour and depth (``ops/image.bilinear_sample_many``).

The temporal branch (a rotated subset of taps a frame, which TAA converges;
the reference turns it on under the stochastic texture qualities) is not
ported and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.core.halton import fibonacci_disc
from arkoserenderer_torch.ops.image import bilinear_sample_many
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


def burley_weight(r: np.ndarray) -> np.ndarray:
    """The Burley diffusion profile R(r) for r in [0, 1] of the sampling
    radius (d = 1/3), in float32."""
    d = 1.0 / 3.0
    r = np.asarray(r, np.float32)
    return (np.exp(-r / d) + np.exp(-r / (3.0 * d))).astype(np.float32)


class SSSSPass(RenderPass):
    name = "SSSS"

    def __init__(self, radius_world: float = 0.015, num_taps: int = 16,
                 temporal: bool | None = None):
        self.radius_world = radius_world
        self.num_taps = num_taps
        # None: the temporal branch under the stochastic texture qualities.
        self.temporal = temporal

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        temporal = self.temporal
        if temporal is None:
            temporal = cfg.texture_quality in ("stochastic", "stochastic1")
        if temporal:
            raise NotImplementedError("SSSS's temporal branch (temporal=True, or ssss under the "
                                      "stochastic texture qualities) is not ported yet")
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneMaterial")
        reg.get("SceneDepth")
        taps = fibonacci_disc(self.num_taps).astype(np.float32)
        weights = burley_weight(np.linalg.norm(taps, axis=-1))
        taps = [(float(x), float(y), float(wt)) for (x, y), wt in zip(taps, weights)]
        radius_scale = self.radius_world * 0.5 * h
        px, py = pixel_centers(cfg, device)

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            sss = state["SceneMaterial"][..., 3]
            depth = state["SceneDepth"]
            d_center = depth.reshape(-1)
            # Reverse-Z with an infinite far plane: depth = near / z, so the
            # projected radius grows with depth.
            g = ctx.camera.unjittered_proj[1, 1]
            r_px = torch.clamp(radius_scale * g * d_center / ctx.camera.near, 0.0, 32.0)
            reject = torch.clamp(d_center * 0.1, min=1e-4)
            acc = color.reshape(-1, 3)
            wsum = torch.ones_like(d_center)[:, None]
            depth_img = depth[..., None]
            for tx, ty, bw in taps:
                c, d_tap = bilinear_sample_many([color, depth_img], px + tx * r_px,
                                                py + ty * r_px)
                wgt = bw * torch.clamp(1.0 - torch.abs(d_tap[:, 0] - d_center) / reject,
                                       0.0, 1.0)
                acc = acc + c * wgt[:, None]
                wsum = wsum + wgt[:, None]
            blurred = (acc / wsum).reshape(color.shape)
            return {"SceneColor": color + (blurred - color) * sss[..., None]}

        return execute
