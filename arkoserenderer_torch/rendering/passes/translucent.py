"""Translucent pass: depth-peeled order-independent transparency over the
opaque scene (port of arkoserenderer_tpu/rendering/passes/translucent.py).

The triangles of translucent materials (which Geometry and the shadow
passes leave out) are set up from the camera without backface culling and
peeled ``layers`` times: layer 0 is the front-most translucent surface, and
each later layer rasters again with the previous layer's depth as the
raster's ``depth_limit`` (``ops/raster.rasterize_tiles``; on the card the
CUDA kernel), so it keeps only fragments strictly behind it. A layer's
fragments behind the opaque SceneDepth are dropped; the rest are shaded by
``ops/shading.shade_visibility_buffer`` (the sun by PCF taps of
ShadowMap.sun where the frame has one) and take their material's base
colour alpha. The layers are composited back to front over SceneColor,
exact for up to ``layers`` overlapping surfaces, and where the first
layer's alpha exceeds 0.5 its velocity replaces SceneVelocity for TAA.

Every layer shades the whole screen, as the reference does.

Publishes: SceneColor, SceneVelocity (updated).
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.ops.shading import shade_visibility_buffer
from arkoserenderer_torch.rendering.passes.geometry import (
    transform_vertices_clip,
    translucent_triangles,
)
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    frame_rows,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class TranslucentPass(RenderPass):
    name = "ForwardTranslucent"

    def __init__(self, layers: int = 1):
        if layers < 1:
            raise ValueError(f"TranslucentPass needs at least one layer, got {layers}")
        self.layers = layers

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        layers = self.layers
        h, w, rcfg = cfg.height, cfg.width, cfg.raster
        full_h = cfg.frame_height
        for name in ("geom.positions", "geom.normals", "geom.tangents", "SceneColor",
                     "SceneDepth", "SceneVelocity"):
            reg.get(name)
        use_shadow = reg.has("ShadowMap.sun")
        if use_shadow:
            reg.get("ShadowMap.sun")
        px, py = pixel_centers(cfg, device)
        st = cfg.scene

        def execute(state: dict, ctx: FrameContext) -> dict:
            scene, cam = ctx.scene, ctx.camera
            translucent = translucent_triangles(scene) & scene.tri_valid
            clip = transform_vertices_clip(scene, cam.view_proj, state["geom.positions"])
            setup = raster.setup_triangles(clip, scene.indices, translucent, w, full_h,
                                           cull_backfaces=False, w_eps=cam.near)
            # Under pixel-band sharding the peel bins and rasters this
            # rank's band.
            bins = raster.bin_triangles(setup, w, h, rcfg, y_offset=ctx.row_offset)
            py_g = frame_rows(py, ctx)
            opaque_depth = state["SceneDepth"]
            base_alpha = scene.materials.base_color_factor[:, 3]

            peeled = []  # (color (h,w,3), alpha (h,w,1), velocity (h,w,2)) front to back
            limit = None  # layer 0: the closest surface
            for _ in range(layers):
                vis, depth = raster.rasterize_tiles(setup, bins, w, h, rcfg,
                                                    y_offset=ctx.row_offset, depth_limit=limit)
                vis = torch.where(depth > opaque_depth, vis, -1)  # reverse-Z: in front
                vis_flat = vis.reshape(-1)
                gb = shade_visibility_buffer(
                    scene, cam, vis_flat, depth.reshape(-1), setup, px, py_g, w, full_h,
                    shadow_map=state["ShadowMap.sun"] if use_shadow else None,
                    sun_shadow_vp=scene.lights.sun_view_proj if use_shadow else None,
                    positions=state["geom.positions"], normals=state["geom.normals"],
                    tangents=state["geom.tangents"],
                    n_spots=st.n_spots, n_points=st.n_points, tex_flags=st,
                )
                tri = setup.orig_tri[torch.clamp(vis_flat, min=0).long()].long()
                alpha = base_alpha[scene.inst_material[scene.tri_instance[tri].long()].long()]
                a = torch.where(gb.valid, alpha, 0.0).reshape(h, w, 1)
                peeled.append((gb.color.reshape(h, w, 3), a, gb.velocity.reshape(h, w, 2)))
                limit = depth  # the next layer lies strictly behind this one

            color = state["SceneColor"]
            for lc, la, _ in reversed(peeled):
                color = color * (1.0 - la) + lc * la
            a0 = peeled[0][1]
            velocity = torch.where(a0 > 0.5, peeled[0][2], state["SceneVelocity"])
            return {"SceneColor": color, "SceneVelocity": velocity}

        return execute
