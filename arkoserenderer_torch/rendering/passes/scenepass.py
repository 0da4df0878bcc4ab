"""Scene pass — always node #0 (port of
arkoserenderer_tpu/rendering/passes/scenepass.py).

Publishes the object-space geometry (geom.positions / normals / tangents)
and, under the packed shading mode, the world-space packed vertex pool
(geom.vtx_world) that the geometry, shadow and shading passes consume. On an animated scene it first blends
each morphed instance's targets, then skins the pool with the frame's
palette (``ops/skinning``); both build new tensors, so the scene's base
pools stay as built. On a hair scene it then places the hair segment's
vertices: each strand point becomes two vertices at +-side, where side is
normalize(cross(tangent, view)) times the point's radius, with the view
vector as their normal and [tangent, 1] as their tangent, written over the
rows from ``hair_vertex_base`` on (clamped, as the reference's
dynamic_update_slice clamps its start, so the rows stay in the pool).
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.ops.packed_shading import build_vertex_world, record_layout_for
from arkoserenderer_torch.ops.skinning import apply_morphs, skin_vertices
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


class ScenePass(RenderPass):
    name = "Scene"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        st = cfg.scene
        reg.publish("geom.positions")
        reg.publish("geom.normals")
        reg.publish("geom.tangents")
        packed = cfg.shading_mode == "packed"
        if packed:
            reg.publish("geom.vtx_world")
        layout = record_layout_for(st)
        has_skin = st.has_skin
        morph_bases = st.morph_vertex_base
        has_hair, hair_base = st.has_hair, st.hair_vertex_base

        def execute(state: dict, ctx: FrameContext) -> dict:
            s = ctx.scene
            p, n, t = s.positions, s.normals, s.tangents
            for i, base in enumerate(morph_bases):
                p, n = apply_morphs(p, n, s.morph_pos[i], s.morph_nrm[i], s.morph_weights[i],
                                    base)
            if has_skin:
                p, n, t = skin_vertices(p, n, t, s.skin_joints, s.skin_weights, s.palette)
            if has_hair:
                p, n, t = hair_ribbons(s, ctx.camera.position, p, n, t, hair_base)
            out = {"geom.positions": p, "geom.normals": n, "geom.tangents": t}
            if packed:
                out["geom.vtx_world"] = build_vertex_world(s, p, n, t, layout=layout)
            return out

        return execute


def hair_ribbons(s, eye: torch.Tensor, p: torch.Tensor, n: torch.Tensor, t: torch.Tensor,
                 base: int):
    """(positions, normals, tangents) with the camera-facing ribbon rows of
    the scene's hair written from vertex ``base`` on (new tensors)."""
    hp = s.hair_points
    view = mx.normalize(eye[None, :] - hp)
    side = mx.normalize(torch.cross(s.hair_tangents, view, dim=-1)) * s.hair_radius[:, None]
    ribbon = torch.stack([hp - side, hp + side], dim=1).reshape(-1, 3)
    nrm = torch.stack([view, view], dim=1).reshape(-1, 3)
    tan = torch.cat([torch.stack([s.hair_tangents] * 2, dim=1).reshape(-1, 3),
                     torch.ones_like(ribbon[:, :1])], dim=-1)
    rows = ribbon.shape[0]
    start = min(max(base, 0), p.shape[0] - rows)
    out = []
    for pool, new in ((p, ribbon), (n, nrm), (t, tan)):
        pool = pool.clone()
        pool[start:start + rows] = new
        out.append(pool)
    return tuple(out)
