"""Debug visualisation: one G-buffer channel as the output (port of
arkoserenderer_tpu/rendering/passes/debugviz.py). ``DebugVisualizePass``
overrides LDR with the channel ``mode`` names, clamped to [0, 1]: triangle
or instance ids as hash colours, depth over its maximum, normals,
velocity, base colour, roughness, metallic, occlusion, SSAO or the RT sun
mask.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry

MODES = (
    "visibility",   # triangle-id hash colours
    "instance",     # instance-id hash colours
    "depth",        # depth over its maximum, grey
    "normal",       # world normal * 0.5 + 0.5
    "velocity",     # |motion| / 8 in red and green
    "base_color",
    "roughness",
    "metallic",
    "occlusion",
    "ssao",
    "shadow_mask",
)

_HASH = 2654435761  # Knuth's multiplicative hash, mod 2^32


def hash_color(ids: torch.Tensor) -> torch.Tensor:
    """Integer ids -> (..., 3) colours: the bytes 0-2 of uint32(id) * 2654435761,
    over 255. The 32-bit product is formed from two 16-bit halves of the
    constant, so no int64 product overflows; the division is a multiply by
    float32(1/255), as the reference's compiled frame does it."""
    x = ids.to(torch.int64) & 0xFFFFFFFF
    h = (x * (_HASH & 0xFFFF) + ((x * (_HASH >> 16)) << 16)) & 0xFFFFFFFF
    return torch.stack([((h >> s) & 255).to(torch.float32) * (1.0 / 255.0)
                        for s in (0, 8, 16)], dim=-1)


class DebugVisualizePass(RenderPass):
    name = "DebugVisualize"

    def __init__(self, mode: str = "visibility"):
        if mode not in MODES:
            raise ValueError(f"unknown debug mode {mode!r}; pick from {MODES}")
        self.mode = mode

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("LDR")
        mode = self.mode

        def grey(x):
            return x[..., None].expand(*x.shape, 3)

        def execute(state: dict, ctx: FrameContext) -> dict:
            if mode in ("visibility", "instance"):
                vis = state["Visibility"]
                ids = vis
                if mode == "instance":
                    orig = state["vis.setup"].orig_tri[torch.clamp(vis, min=0).long()]
                    ids = ctx.scene.tri_instance[orig.long()]
                out = torch.where((vis >= 0)[..., None], hash_color(ids), 0.0)
            elif mode == "depth":
                d = state["SceneDepth"]
                out = grey(d / torch.clamp(d.max(), min=1e-6))
            elif mode == "normal":
                out = state["SceneNormal"] * 0.5 + 0.5
            elif mode == "velocity":
                v = state["SceneVelocity"]
                out = torch.cat([torch.abs(v) / 8.0, torch.zeros_like(v[..., :1])], dim=-1)
            elif mode == "base_color":
                out = state["SceneBaseColor"]
            elif mode in ("roughness", "metallic", "occlusion"):
                out = grey(state["SceneMaterial"][..., ("roughness", "metallic",
                                                        "occlusion").index(mode)])
            elif mode == "ssao":
                out = grey(state["SSAO"])
            else:
                out = grey(state["ShadowMask.sun"])
            return {"LDR": torch.clamp(out, 0.0, 1.0)}

        return execute
