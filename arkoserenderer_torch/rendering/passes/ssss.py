"""Screen-space subsurface scattering (port of
arkoserenderer_tpu/rendering/passes/ssss.py).

Burley diffusion-profile taps on a Fibonacci disc, blended into the pixels
of subsurface materials (SceneMaterial's subsurface channel), with
depth-aware tap rejection. The world-space scattering radius maps to pixels
through the projection, so the blur shrinks with distance. In the dense
branch every tap is one bilinear fetch of colour and depth
(``ops/image.bilinear_sample_many``). The temporal branch takes
``stochastic_taps`` nearest taps of a smaller disc, rotated per pixel by the
frame's blue noise (salt 61) and weighted as num_taps / stochastic_taps
dense taps, which TAA converges; ``temporal=None`` turns it on under the
stochastic texture qualities, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arkoserenderer_torch.core.halton import fibonacci_disc
from arkoserenderer_torch.ops.image import bilinear_sample_many
from arkoserenderer_torch.ops.postprocess import _nearest_sample_many, _pixel_noise
from arkoserenderer_torch.rendering.passes.post import temporal_of
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
                 temporal: bool | None = None, stochastic_taps: int = 4):
        self.radius_world = radius_world
        self.num_taps = num_taps
        # None: the temporal branch under the stochastic texture qualities.
        self.temporal = temporal
        self.stochastic_taps = stochastic_taps

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        temporal = temporal_of(cfg, self.temporal)
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneMaterial")
        reg.get("SceneDepth")
        taps = fibonacci_disc(self.stochastic_taps if temporal else self.num_taps)
        taps = taps.astype(np.float32)
        weights = burley_weight(np.linalg.norm(taps, axis=-1))
        if temporal:  # each tap stands for num_taps / stochastic_taps dense taps
            weights = np.float32(self.num_taps / len(taps)) * weights
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
            if temporal:
                ang = _pixel_noise(px, py, ctx.frame_index, 61) * (2.0 * math.pi)
                ca, sa = torch.cos(ang), torch.sin(ang)
            for tx, ty, bw in taps:
                if temporal:
                    c, d_tap = _nearest_sample_many(
                        [color, depth_img], px + (tx * ca - ty * sa) * r_px,
                        py + (tx * sa + ty * ca) * r_px)
                else:
                    c, d_tap = bilinear_sample_many([color, depth_img], px + tx * r_px,
                                                    py + ty * r_px)
                wgt = bw * torch.clamp(1.0 - torch.abs(d_tap[:, 0] - d_center) / reject,
                                       0.0, 1.0)
                acc = acc + c * wgt[:, None]
                wsum = wsum + wgt[:, None]
            blurred = (acc / wsum).reshape(color.shape)
            return {"SceneColor": color + (blurred - color) * sss[..., None]}

        return execute
