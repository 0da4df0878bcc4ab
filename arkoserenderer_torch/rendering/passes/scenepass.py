"""Scene pass — always node #0 (port of
arkoserenderer_tpu/rendering/passes/scenepass.py).

Publishes the object-space geometry (geom.positions / normals / tangents)
and, under the packed shading mode, the world-space packed vertex pool
(geom.vtx_world) that the geometry, shadow and shading passes consume. On an animated scene it first blends
each morphed instance's targets, then skins the pool with the frame's
palette (``ops/skinning``); both build new tensors, so the scene's base
pools stay as built. Hair is not ported.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.packed_shading import build_vertex_world, record_layout_for
from arkoserenderer_torch.ops.skinning import apply_morphs, skin_vertices
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


class ScenePass(RenderPass):
    name = "Scene"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        st = cfg.scene
        if st.has_hair:
            raise NotImplementedError("hair (camera-facing ribbons) is not ported yet")
        reg.publish("geom.positions")
        reg.publish("geom.normals")
        reg.publish("geom.tangents")
        packed = cfg.shading_mode == "packed"
        if packed:
            reg.publish("geom.vtx_world")
        layout = record_layout_for(st)
        has_skin = st.has_skin
        morph_bases = st.morph_vertex_base

        def execute(state: dict, ctx: FrameContext) -> dict:
            s = ctx.scene
            p, n, t = s.positions, s.normals, s.tangents
            for i, base in enumerate(morph_bases):
                p, n = apply_morphs(p, n, s.morph_pos[i], s.morph_nrm[i], s.morph_weights[i],
                                    base)
            if has_skin:
                p, n, t = skin_vertices(p, n, t, s.skin_joints, s.skin_weights, s.palette)
            out = {"geom.positions": p, "geom.normals": n, "geom.tangents": t}
            if packed:
                out["geom.vtx_world"] = build_vertex_world(s, p, n, t, layout=layout)
            return out

        return execute
