"""Shadow-map passes (port of arkoserenderer_tpu/rendering/passes/shadow.py):
the directional sun map and the per-spot-light local maps.

SunShadow
---------

A depth-only raster from the sun's ortho view (no backface culling, so
single-sided geometry casts) through the same stage-4 kernel as the camera,
then, under the packed shading mode, prefiltered VSM moments; the
reference mode shades with PCF taps of the map itself and makes no
moments. Translucent triangles cast no shadow (in both passes).

Static-shadow cache: when nothing that casts shadows can move, the map is
rendered once and reused until the host bumps the scene version. The
reference decides that on the device (a ``lax.cond``); here the host already
holds both versions as Python ints and knows whether this is frame 0, so it
is a plain branch (``host_step``) and the frame reads nothing back; a
captured frame has a graph for each branch, and a steady frame's holds no
sun raster. A dynamic scene (moving instances, skinning, morph
targets, hair) rasters the sun every frame, and both maps are transient.

Under pixel-band sharding each rank rasters its band of the map's rows,
``[rank * S/n, (rank + 1) * S/n)`` at that ``y_offset``, and the bands are
gathered into the whole map on every rank; the moments and the cache then
run on the whole map as unsharded.

Publishes: ShadowMap.sun (S, S) f32 reverse-Z depth and, packed,
ShadowMoments.sun (S/2, S/2, 2) f32. Counts raster.sun_dropped and
raster.sun_binned in the frame record in a frame that rasters the map.

LocalShadow
-----------
One depth-only perspective raster per shadow-casting spot light, through
the same stage-4 kernel, at ``local_shadow_map_size``; shading PCF-samples
each light's tile through the light's matrix.

Publishes: ShadowMap.locals (n_spots, A, A) f32 reverse-Z depth; the tiles
of lights that cast no shadow stay at the far clear value. Under pixel-band
sharding every rank rasters the whole (small) atlas, as the reference does.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core.types import DEPTH_FAR
from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.ops.shadow import shadow_moments
from arkoserenderer_torch.rendering.passes.geometry import (
    count_bins,
    transform_vertices_clip,
    translucent_triangles,
    visible_triangles,
    world_to_clip,
)
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


def sun_shadow_cacheable(scene_static) -> bool:
    """Whether the sun map is rendered once and cached: nothing that casts
    shadows can move."""
    st = scene_static
    return not (st.dynamic or st.has_skin or st.has_morphs or st.has_hair)


class SunShadowPass(RenderPass):
    name = "SunShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        s = cfg.shadow_map_size
        st = cfg.scene
        packed = cfg.shading_mode == "packed"
        reg.get("geom.positions")
        cacheable = sun_shadow_cacheable(st)
        if packed:
            reg.get("geom.vtx_world")
            reg.create("ShadowMoments.sun", (s // 2, s // 2, 2), torch.float32,
                       persistent=cacheable)
        reg.create("ShadowMap.sun", (s, s), torch.float32, clear=DEPTH_FAR,
                   persistent=cacheable)
        if cacheable:
            reg.create("scene.version", (), None, clear=-1)
            reg.create("SunShadow.version", (), None, clear=-2)
        rcfg = cfg.raster
        band_s = s // cfg.shard_count  # the rows of the map each rank rasters
        if band_s % rcfg.tile_h or s % rcfg.tile_w or s % cfg.shard_count:
            raise ValueError("shadow map size must be a multiple of the raster tile in "
                             "each band")

        def render(state: dict, ctx: FrameContext) -> dict:
            sc = ctx.scene
            sun_vp = sc.lights.sun_view_proj
            if packed:
                clip = world_to_clip(sun_vp, state["geom.vtx_world"][:, 0:3])
            else:
                clip = transform_vertices_clip(sc, sun_vp, state["geom.positions"])
            casters = visible_triangles(sc, sun_vp, ctx.camera.position)
            if st.has_translucent:
                casters = casters & ~translucent_triangles(sc)
            setup = raster.setup_triangles(clip, sc.indices, casters, s, s,
                                           cull_backfaces=False)
            if ctx.band is None:
                bins = raster.bin_triangles(setup, s, s, rcfg)
                count_bins(ctx, "sun", bins)
                _, depth = raster.rasterize_tiles(setup, bins, s, s, rcfg, depth_only=True)
            else:
                y0 = ctx.band.rank * band_s
                bins = raster.bin_triangles(setup, s, band_s, rcfg, y_offset=y0)
                count_bins(ctx, "sun", bins)
                _, band_depth = raster.rasterize_tiles(setup, bins, s, band_s, rcfg,
                                                       depth_only=True, y_offset=y0)
                depth = ctx.band.gather_rows(band_depth)
            if packed:
                return {"ShadowMap.sun": depth, "ShadowMoments.sun": shadow_moments(depth)}
            return {"ShadowMap.sun": depth}

        self._cacheable = cacheable

        def execute(state: dict, ctx: FrameContext) -> dict:
            if not cacheable:
                return render(state, ctx)
            dirty, versions = self.host_step(state, ctx.first_frame)
            if dirty:
                out = render(state, ctx)
            else:
                out = {k: state[k] for k in ("ShadowMap.sun", "ShadowMoments.sun") if k in state}
            return {**out, **versions}

        return execute

    def host_step(self, state: dict, first_frame: bool) -> tuple:
        """The cached map's branch, on the host's versions: render on the
        first frame and whenever the host bumped the scene version, else
        keep the map (the reference's ``lax.cond``; a captured frame has a
        graph for each)."""
        if not self._cacheable:
            return None, {}
        version = state["scene.version"]
        dirty = bool(first_frame or version != state["SunShadow.version"])
        return dirty, {"SunShadow.version": version, "scene.version": version}


class LocalShadowPass(RenderPass):
    name = "LocalShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        a = cfg.local_shadow_map_size
        st = cfg.scene
        n_tiles = max(st.n_spots, 1)
        casters = st.spot_shadow_casters
        reg.get("geom.positions")
        reg.create("ShadowMap.locals", (n_tiles, a, a), torch.float32, clear=DEPTH_FAR)
        rcfg = cfg.raster
        if a % rcfg.tile_h or a % rcfg.tile_w:
            raise ValueError("local shadow map size must be a multiple of the raster tile")

        def execute(state: dict, ctx: FrameContext) -> dict:
            tiles = []
            opaque = ~translucent_triangles(ctx.scene) if st.has_translucent else None
            for i in range(n_tiles):
                if i >= len(casters) or not casters[i]:
                    tiles.append(torch.full((a, a), DEPTH_FAR, dtype=torch.float32,
                                            device=ctx.scene.positions.device))
                    continue
                vp = ctx.scene.lights.spot_view_proj[i]
                clip = transform_vertices_clip(ctx.scene, vp, state["geom.positions"])
                tris = visible_triangles(ctx.scene, vp, ctx.camera.position)
                if opaque is not None:
                    tris = tris & opaque
                setup = raster.setup_triangles(clip, ctx.scene.indices, tris, a, a,
                                               cull_backfaces=False)
                bins = raster.bin_triangles(setup, a, a, rcfg)
                tiles.append(raster.rasterize_tiles(setup, bins, a, a, rcfg, depth_only=True)[1])
            return {"ShadowMap.locals": torch.stack(tiles)}

        return execute
