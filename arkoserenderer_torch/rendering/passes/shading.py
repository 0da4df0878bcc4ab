"""Deferred shading pass (port of
arkoserenderer_tpu/rendering/passes/shading.py ``VisibilityShadingPass``,
packed branch: trilinear textures and the bilinear VSM sun — the
reference's defaults; its other texture and shadow filters are not ported
yet). Spot and point lights are shaded at the scene's static counts; a
spot flagged as a shadow caster samples its tile of ShadowMap.locals when
the LocalShadow pass ran before this one.

Publishes SceneColor, SceneNormal, SceneVelocity, SceneBaseColor,
SceneMaterial and SceneCoverage.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.packed_shading import record_layout_for, shade_packed
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class VisibilityShadingPass(RenderPass):
    name = "VisibilityShading"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        st = cfg.scene
        reg.get("Visibility")
        reg.get("SceneDepth")
        reg.get("vis.setup")
        reg.get("vis.records")
        any_tex = (st.uses_base_tex or st.uses_normal_tex or st.uses_mr_tex
                   or st.uses_emissive_tex or st.uses_occlusion_tex)
        use_moments = reg.has("ShadowMoments.sun")
        if use_moments:
            reg.get("ShadowMoments.sun")
        use_local_shadow = reg.has("ShadowMap.locals")
        if use_local_shadow:
            reg.get("ShadowMap.locals")
        for name, shape in (("SceneColor", (h, w, 3)), ("SceneNormal", (h, w, 3)),
                            ("SceneVelocity", (h, w, 2)), ("SceneBaseColor", (h, w, 3)),
                            ("SceneMaterial", (h, w, 4))):
            reg.create(name, shape, torch.float32)
        reg.create("SceneCoverage", (h, w), torch.bool)
        px, py = pixel_centers(cfg, device)
        layout = record_layout_for(st)

        def execute(state: dict, ctx: FrameContext) -> dict:
            gb = shade_packed(
                ctx.scene, ctx.camera,
                state["Visibility"].reshape(-1), state["SceneDepth"].reshape(-1),
                state["vis.records"], px, py, w, h,
                shadow_moments=state["ShadowMoments.sun"] if use_moments else None,
                sun_shadow_vp=ctx.scene.lights.sun_view_proj if use_moments else None,
                local_shadow_maps=state["ShadowMap.locals"] if use_local_shadow else None,
                spot_shadow_flags=st.spot_shadow_casters if use_local_shadow else None,
                n_spots=st.n_spots,
                n_points=st.n_points,
                any_tex=any_tex,
                layout=layout,
            )
            return {
                "SceneColor": gb.color.reshape(h, w, 3),
                "SceneNormal": gb.normal.reshape(h, w, 3),
                "SceneVelocity": gb.velocity.reshape(h, w, 2),
                "SceneBaseColor": gb.base_color.reshape(h, w, 3),
                "SceneMaterial": gb.material.reshape(h, w, 4),
                "SceneCoverage": gb.valid.reshape(h, w),
            }

        return execute
