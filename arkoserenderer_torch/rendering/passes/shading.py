"""Deferred shading pass (port of
arkoserenderer_tpu/rendering/passes/shading.py ``VisibilityShadingPass``).

Under the packed shading mode (``ops/packed_shading``): textures filtered
by ``cfg.texture_quality`` ("auto" is trilinear), the sun's VSM tapped by
``cfg.shadow_filter`` ("auto" is bilinear); the stochastic filters draw
blue noise of the frame index. Under ``shading_mode="reference"``
(``ops/shading.shade_visibility_buffer``): the per-field path over the
setup rows and the object-space pools, the RGBA8 texture pool sampled by
``ops/texture.sample_grad``, the sun by PCF taps of ShadowMap.sun; it
takes no ray-traced local-light masks, as in the reference.
Spot and point lights are shaded at the scene's static counts; a spot
flagged as a shadow caster samples its tile of ShadowMap.locals when the
LocalShadow pass ran before this one. The ray-traced masks win where
their passes ran: ShadowMask.sun (RTShadow) over the sun's map,
ShadowMask.locals and ShadowMask.points (RTLocalShadow) for the local
lights.

Publishes SceneColor, SceneNormal, SceneVelocity, SceneBaseColor,
SceneMaterial and SceneCoverage.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.packed_shading import record_layout_for, shade_packed
from arkoserenderer_torch.ops.shading import shade_visibility_buffer
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    frame_rows,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class VisibilityShadingPass(RenderPass):
    name = "VisibilityShading"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        st = cfg.scene
        reg.get("Visibility")
        reg.get("SceneDepth")
        reg.get("vis.setup")
        packed = cfg.shading_mode == "packed"
        if packed:
            reg.get("vis.records")
        else:
            for name in ("geom.positions", "geom.normals", "geom.tangents"):
                reg.get(name)
        any_tex = (st.uses_base_tex or st.uses_normal_tex or st.uses_mr_tex
                   or st.uses_emissive_tex or st.uses_occlusion_tex)
        use_moments = packed and reg.has("ShadowMoments.sun")
        use_map = not packed and reg.has("ShadowMap.sun")
        if use_moments:
            reg.get("ShadowMoments.sun")
        elif use_map:
            reg.get("ShadowMap.sun")
        use_local_shadow = reg.has("ShadowMap.locals")
        if use_local_shadow:
            reg.get("ShadowMap.locals")
        use_rt_shadow = reg.has("ShadowMask.sun")
        if use_rt_shadow:
            reg.get("ShadowMask.sun")
        use_rt_local = reg.has("ShadowMask.locals")
        if use_rt_local:
            reg.get("ShadowMask.locals")
            reg.get("ShadowMask.points")
        for name, shape in (("SceneColor", (h, w, 3)), ("SceneNormal", (h, w, 3)),
                            ("SceneVelocity", (h, w, 2)), ("SceneBaseColor", (h, w, 3)),
                            ("SceneMaterial", (h, w, 4))):
            reg.create(name, shape, torch.float32)
        reg.create("SceneCoverage", (h, w), torch.bool)
        px, py = pixel_centers(cfg, device)
        layout = record_layout_for(st)
        quality = "trilinear" if cfg.texture_quality == "auto" else cfg.texture_quality
        shadow_filter = "bilinear" if cfg.shadow_filter == "auto" else cfg.shadow_filter

        def shade(state: dict, ctx: FrameContext):
            py_g = frame_rows(py, ctx)
            if not packed:
                sun_vp = ctx.scene.lights.sun_view_proj if use_map else None
                return shade_visibility_buffer(
                    ctx.scene, ctx.camera,
                    state["Visibility"].reshape(-1), state["SceneDepth"].reshape(-1),
                    state["vis.setup"], px, py_g, w, full_h,
                    shadow_map=state["ShadowMap.sun"] if use_map else None,
                    sun_shadow_vp=sun_vp,
                    shadow_mask=state["ShadowMask.sun"].reshape(-1) if use_rt_shadow else None,
                    local_shadow_maps=state["ShadowMap.locals"] if use_local_shadow else None,
                    spot_shadow_flags=st.spot_shadow_casters if use_local_shadow else None,
                    positions=state["geom.positions"], normals=state["geom.normals"],
                    tangents=state["geom.tangents"],
                    n_spots=st.n_spots, n_points=st.n_points, tex_flags=st,
                    texture_quality=quality)
            return shade_packed(
                ctx.scene, ctx.camera,
                state["Visibility"].reshape(-1), state["SceneDepth"].reshape(-1),
                state["vis.records"], px, py_g, w, full_h,
                shadow_moments=state["ShadowMoments.sun"] if use_moments else None,
                sun_shadow_vp=ctx.scene.lights.sun_view_proj if use_moments else None,
                shadow_mask=state["ShadowMask.sun"].reshape(-1) if use_rt_shadow else None,
                local_shadow_maps=state["ShadowMap.locals"] if use_local_shadow else None,
                spot_shadow_flags=st.spot_shadow_casters if use_local_shadow else None,
                rt_spot_masks=(state["ShadowMask.locals"].flatten(1) if use_rt_local
                               else None),
                rt_point_masks=(state["ShadowMask.points"].flatten(1) if use_rt_local
                                else None),
                n_spots=st.n_spots,
                n_points=st.n_points,
                any_tex=any_tex,
                mip_bias=cfg.mip_bias,
                texture_quality=quality,
                shadow_filter=shadow_filter,
                frame_index=ctx.frame_index,
                layout=layout,
            )

        def execute(state: dict, ctx: FrameContext) -> dict:
            gb = shade(state, ctx)
            return {
                "SceneColor": gb.color.reshape(h, w, 3),
                "SceneNormal": gb.normal.reshape(h, w, 3),
                "SceneVelocity": gb.velocity.reshape(h, w, 2),
                "SceneBaseColor": gb.base_color.reshape(h, w, 3),
                "SceneMaterial": gb.material.reshape(h, w, 4),
                "SceneCoverage": gb.valid.reshape(h, w),
            }

        return execute
