"""Post-chain passes (port of arkoserenderer_tpu/rendering/passes/post.py):
SSAO, LightingCompose, Fog, MotionBlur, DepthOfField, FXAA and CAS. Each
wraps a function of ops/ssao or ops/postprocess; all take their dense
branch (every sample and tap, every frame), which is what the reference's
default texture quality resolves to.

LightingCompose is the branch without DDGI or reflections: direct light
(already in SceneColor) plus SH-2 environment irradiance and the flat
ambient, modulated by diffuse albedo, material occlusion and, when the SSAO
pass ran, its ambient visibility.
"""

from __future__ import annotations

import math

import torch

from arkoserenderer_torch.ops import postprocess as pp
from arkoserenderer_torch.ops import ssao as ssao_ops
from arkoserenderer_torch.ops.envmap import ambient_of_normal, average_radiance
from arkoserenderer_torch.ops.image import blur3
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer_torch.rendering.registry import Registry


class SSAOPass(RenderPass):
    name = "SSAO"

    def __init__(self, num_samples: int = 16, radius: float = 0.5, intensity: float = 1.0):
        self.kernel = ssao_ops.make_ssao_kernel(num_samples)
        self.radius = radius
        self.intensity = intensity

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        reg.get("SceneDepth")
        reg.get("SceneNormal")
        reg.get("SceneCoverage")
        reg.create("SSAO", (h, w), torch.float32, clear=1.0)
        px, py = pixel_centers(cfg, device)
        rotation = ssao_ops.kernel_rotation(px, py)  # a constant of the pixel grid
        kernel, radius, intensity = self.kernel, self.radius, self.intensity

        def execute(state: dict, ctx: FrameContext) -> dict:
            ao = ssao_ops.ssao(
                state["SceneDepth"],
                state["SceneNormal"].reshape(-1, 3),
                state["SceneCoverage"].reshape(-1),
                px, py,
                ctx.camera.unjittered_view_proj, ctx.camera.near,
                w, h, kernel, radius=radius, intensity=intensity, rotation=rotation,
            )
            return {"SSAO": blur3(ao.reshape(h, w, 1))[..., 0]}

        return execute


class LightingComposePass(RenderPass):
    name = "LightingCompose"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        if reg.has("SceneReflections") or reg.has("DDGI.irradiance"):
            raise NotImplementedError("reflections and DDGI are not ported yet")
        for name in ("SceneColor", "SceneBaseColor", "SceneMaterial", "SceneCoverage",
                     "SceneNormal"):
            reg.get(name)
        use_ssao = reg.has("SSAO")
        if use_ssao:
            reg.get("SSAO")

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            base = state["SceneBaseColor"]
            mat = state["SceneMaterial"]  # roughness, metallic, occlusion, subsurface
            valid = state["SceneCoverage"][..., None]
            ambient = ambient_of_normal(
                ctx.scene.env_map, state["SceneNormal"].reshape(-1, 3),
                ctx.scene.env_brightness,
            ).reshape(h, w, 3)
            ambient = (ambient + ctx.scene.lights.ambient_lx / math.pi) * ctx.camera.exposure
            ao = mat[..., 2:3]
            if use_ssao:
                ao = ao * state["SSAO"][..., None]
            diffuse = base * (1.0 - mat[..., 1:2])
            out = color + torch.where(valid, diffuse * ambient * ao, 0.0)
            return {"SceneColor": out}

        return execute


class FogPass(RenderPass):
    name = "Fog"

    def __init__(self, density: float = 0.02, height_falloff: float = 0.05):
        self.density = density
        self.height_falloff = height_falloff

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneDepth")
        reg.get("SceneCoverage")
        px, py = pixel_centers(cfg, device)
        density, falloff = self.density, self.height_falloff

        def execute(state: dict, ctx: FrameContext) -> dict:
            inv_vp = ssao_ops.inverse4(ctx.camera.unjittered_view_proj)
            world = ssao_ops.reconstruct_world_pos(
                state["SceneDepth"].reshape(-1), px, py, inv_vp, w, h
            ).reshape(h, w, 3)
            env_avg = average_radiance(ctx.scene.env_map) * ctx.scene.env_brightness
            out = pp.apply_fog(
                state["SceneColor"], world, state["SceneCoverage"],
                ctx.camera.position, env_avg * ctx.camera.exposure,
                density=density, height_falloff=falloff,
            )
            return {"SceneColor": out}

        return execute


class MotionBlurPass(RenderPass):
    name = "MotionBlur"

    def __init__(self, num_taps: int = 8, shutter_scale: float = 0.5):
        self.num_taps = num_taps
        self.shutter_scale = shutter_scale

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("SceneColor")
        reg.get("SceneVelocity")
        reg.get("SceneDepth")
        shutter, taps = self.shutter_scale, self.num_taps
        tile = 16 if cfg.height % 16 == 0 and cfg.width % 16 == 0 else 8
        if cfg.height % tile or cfg.width % tile:
            raise ValueError("motion blur needs a frame size that is a multiple of 8")

        def execute(state: dict, ctx: FrameContext) -> dict:
            out = pp.motion_blur(
                state["SceneColor"], state["SceneVelocity"], state["SceneDepth"],
                shutter_scale=shutter, num_taps=taps, tile=tile,
            )
            return {"SceneColor": out}

        return execute


class DepthOfFieldPass(RenderPass):
    name = "DepthOfField"

    def __init__(self, num_taps: int = 24, max_coc: float = 16.0):
        self.num_taps = num_taps
        self.max_coc = max_coc

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneDepth")
        reg.get("SceneCoverage")
        reg.create("SceneCoC", (h, w), torch.float32)
        taps, max_coc = self.num_taps, self.max_coc

        def execute(state: dict, ctx: FrameContext) -> dict:
            coc = pp.compute_coc(
                state["SceneDepth"], state["SceneCoverage"],
                ctx.camera.near, ctx.camera.focus_depth, ctx.camera.aperture_px,
                max_coc=max_coc,
            )
            return {"SceneColor": pp.depth_of_field(state["SceneColor"], coc, num_taps=taps),
                    "SceneCoC": coc}

        return execute


class FXAAPass(RenderPass):
    name = "FXAA"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("LDR")

        def execute(state: dict, ctx: FrameContext) -> dict:
            return {"LDR": pp.fxaa(state["LDR"])}

        return execute


class CASPass(RenderPass):
    name = "CAS"

    def __init__(self, sharpness: float = 0.5):
        self.sharpness = sharpness

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("LDR")
        sharp = self.sharpness

        def execute(state: dict, ctx: FrameContext) -> dict:
            return {"LDR": pp.cas(state["LDR"], sharp)}

        return execute
