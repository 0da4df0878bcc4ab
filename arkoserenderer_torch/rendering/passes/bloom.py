"""Bloom (port of arkoserenderer_tpu/rendering/passes/bloom.py): a pyramid
built by blur + 2x box downsampling, collapsed back up with tent-filter
upsamples and blended into SceneColor with a small weight."""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.image import blur3, downsample2x, upsample2x
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


class BloomPass(RenderPass):
    name = "Bloom"

    def __init__(self, levels: int = 5, strength: float = 0.04):
        self.levels = levels
        self.strength = strength

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("SceneColor")
        # The level count is clamped to what the frame can halve evenly: a
        # host integer, fixed here.
        h, w = cfg.height, cfg.width
        levels = 0
        while levels < self.levels and h % 2 == 0 and w % 2 == 0 and h > 8 and w > 8:
            h //= 2
            w //= 2
            levels += 1
        strength = self.strength

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            chain = [color]
            x = color
            for _ in range(levels):
                x = downsample2x(blur3(x))
                chain.append(x)
            up = chain[-1]
            for i in range(levels - 1, 0, -1):
                up = chain[i] + upsample2x(up)
            bloom = upsample2x(up) if levels > 0 else color
            return {"SceneColor": color + strength * bloom}

        return execute
