"""Shadow-map passes (port of arkoserenderer_tpu/rendering/passes/shadow.py):
the directional sun map and the per-spot-light local maps.

SunShadow
---------

A depth-only raster from the sun's ortho view (no backface culling, so
single-sided geometry casts) through the same stage-4 kernel as the camera,
then prefiltered VSM moments.

Static-shadow cache: when nothing that casts shadows can move, the map is
rendered once and reused until the host bumps the scene version. The
reference decides that on the device (a ``lax.cond``); here the host already
holds both versions as Python ints, so it is a plain branch and the frame
reads nothing back.

Publishes: ShadowMap.sun (S, S) f32 reverse-Z depth and ShadowMoments.sun
(S/2, S/2, 2) f32.

LocalShadow
-----------
One depth-only perspective raster per shadow-casting spot light, through
the same stage-4 kernel, at ``local_shadow_map_size``; shading PCF-samples
each light's tile through the light's matrix.

Publishes: ShadowMap.locals (n_spots, A, A) f32 reverse-Z depth; the tiles
of lights that cast no shadow stay at the far clear value.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core.types import DEPTH_FAR
from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.ops.shadow import shadow_moments
from arkoserenderer_torch.rendering.passes.geometry import (
    transform_vertices_clip,
    visible_triangles,
    world_to_clip,
)
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


class SunShadowPass(RenderPass):
    name = "SunShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        s = cfg.shadow_map_size
        st = cfg.scene
        if st.has_translucent:
            raise NotImplementedError("translucent shadow casters are not ported yet")
        reg.get("geom.positions")
        reg.get("geom.vtx_world")
        cacheable = not (st.dynamic or st.has_skin or st.has_morphs or st.has_hair)
        reg.create("ShadowMoments.sun", (s // 2, s // 2, 2), torch.float32,
                   persistent=cacheable)
        reg.create("ShadowMap.sun", (s, s), torch.float32, clear=DEPTH_FAR,
                   persistent=cacheable)
        if cacheable:
            reg.create("scene.version", (), None, clear=-1)
            reg.create("SunShadow.version", (), None, clear=-2)
        rcfg = cfg.raster
        if s % rcfg.tile_h or s % rcfg.tile_w:
            raise ValueError("shadow map size must be a multiple of the raster tile")

        def render(state: dict, ctx: FrameContext):
            sun_vp = ctx.scene.lights.sun_view_proj
            clip = world_to_clip(sun_vp, state["geom.vtx_world"][:, 0:3])
            setup = raster.setup_triangles(
                clip, ctx.scene.indices,
                visible_triangles(ctx.scene, sun_vp, ctx.camera.position), s, s,
                cull_backfaces=False,
            )
            bins = raster.bin_triangles(setup, s, s, rcfg)
            _, depth = raster.rasterize_tiles(setup, bins, s, s, rcfg, depth_only=True)
            return depth, shadow_moments(depth)

        def execute(state: dict, ctx: FrameContext) -> dict:
            if not cacheable:
                depth, moments = render(state, ctx)
                return {"ShadowMap.sun": depth, "ShadowMoments.sun": moments}
            version = state["scene.version"]
            if ctx.frame_index == 0 or version != state["SunShadow.version"]:
                depth, moments = render(state, ctx)
            else:
                depth, moments = state["ShadowMap.sun"], state["ShadowMoments.sun"]
            return {
                "ShadowMap.sun": depth, "ShadowMoments.sun": moments,
                "SunShadow.version": version, "scene.version": version,
            }

        return execute


class LocalShadowPass(RenderPass):
    name = "LocalShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        a = cfg.local_shadow_map_size
        st = cfg.scene
        if st.has_translucent:
            raise NotImplementedError("translucent shadow casters are not ported yet")
        n_tiles = max(st.n_spots, 1)
        casters = st.spot_shadow_casters
        reg.get("geom.positions")
        reg.create("ShadowMap.locals", (n_tiles, a, a), torch.float32, clear=DEPTH_FAR)
        rcfg = cfg.raster
        if a % rcfg.tile_h or a % rcfg.tile_w:
            raise ValueError("local shadow map size must be a multiple of the raster tile")

        def execute(state: dict, ctx: FrameContext) -> dict:
            tiles = []
            for i in range(n_tiles):
                if i >= len(casters) or not casters[i]:
                    tiles.append(torch.full((a, a), DEPTH_FAR, dtype=torch.float32,
                                            device=ctx.scene.positions.device))
                    continue
                vp = ctx.scene.lights.spot_view_proj[i]
                clip = transform_vertices_clip(ctx.scene, vp, state["geom.positions"])
                setup = raster.setup_triangles(
                    clip, ctx.scene.indices,
                    visible_triangles(ctx.scene, vp, ctx.camera.position), a, a,
                    cull_backfaces=False,
                )
                bins = raster.bin_triangles(setup, a, a, rcfg)
                tiles.append(raster.rasterize_tiles(setup, bins, a, a, rcfg, depth_only=True)[1])
            return {"ShadowMap.locals": torch.stack(tiles)}

        return execute
