"""Post-chain passes (port of arkoserenderer_tpu/rendering/passes/post.py):
SSAO, LightingCompose, Fog, MotionBlur, DepthOfField, FXAA and CAS. Each
wraps a function of ops/ssao or ops/postprocess. SSAO, MotionBlur and
DepthOfField take their dense branch (every sample and tap, every frame)
unless ``temporal``: then a few hashed or jittered samples a frame, which
TAA converges. ``temporal=None`` turns it on under the stochastic texture
qualities, as in the reference.

LightingCompose adds to the direct light (already in SceneColor) the
diffuse ambient: the DDGI probes' irradiance when the DDGI pass ran (at
every pixel, or at ``ddgi_sample_scale=2`` at one pixel of each 2x2 block,
upsampled by nearest depth), else SH-2 environment irradiance and the flat
ambient; modulated by diffuse albedo, material occlusion and, when the SSAO
pass ran, its ambient visibility; plus SceneReflections where RTReflections
ran.

Under pixel-band sharding SSAO's occlusion fetches read the gathered
whole-frame depth and its blur takes a halo row from each neighbouring
band; the passes that reconstruct world positions (SSAO, the DDGI
lookup, Fog) use frame rows. MotionBlur, DepthOfField, FXAA and CAS stay
band-local and clamp at the band's edge, as in the reference.
"""

from __future__ import annotations

import math

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.ops import ddgi as ddgi_ops
from arkoserenderer_torch.ops import postprocess as pp
from arkoserenderer_torch.ops import ssao as ssao_ops
from arkoserenderer_torch.ops.envmap import ambient_of_normal, average_radiance
from arkoserenderer_torch.ops.image import (
    band_halo_rows,
    blur3,
    upsample_nearest_depth,
)
from arkoserenderer_torch.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    frame_rows,
    pixel_centers,
)
from arkoserenderer_torch.rendering.passes.ddgi import STATE_KEYS as DDGI_KEYS
from arkoserenderer_torch.rendering.passes.ddgi import ddgi_state
from arkoserenderer_torch.rendering.registry import Registry


def temporal_of(cfg: PipelineConfig, temporal: bool | None) -> bool:
    """A pass's ``temporal`` flag, with None resolved as the reference
    resolves it: on under the stochastic texture qualities."""
    if temporal is None:
        return cfg.texture_quality in ("stochastic", "stochastic1")
    return temporal


class SSAOPass(RenderPass):
    name = "SSAO"

    def __init__(self, num_samples: int = 16, radius: float = 0.5, intensity: float = 1.0,
                 temporal: bool | None = None, samples_per_frame: int = 2):
        self.kernel = ssao_ops.make_ssao_kernel(num_samples)
        self.radius = radius
        self.intensity = intensity
        self.temporal = temporal
        self.samples_per_frame = samples_per_frame

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        reg.get("SceneDepth")
        reg.get("SceneNormal")
        reg.get("SceneCoverage")
        reg.create("SSAO", (h, w), torch.float32, clear=1.0)
        px, py = pixel_centers(cfg, device)
        rotation = ssao_ops.kernel_rotation(px, py)  # a constant of the pixel grid
        kernel, radius, intensity = self.kernel, self.radius, self.intensity
        spf = self.samples_per_frame if temporal_of(cfg, self.temporal) else None

        def execute(state: dict, ctx: FrameContext) -> dict:
            depth, band = state["SceneDepth"], ctx.band
            py_g = frame_rows(py, ctx)
            ao = ssao_ops.ssao(
                depth,
                state["SceneNormal"].reshape(-1, 3),
                state["SceneCoverage"].reshape(-1),
                px, py_g,
                ctx.camera.unjittered_view_proj, ctx.camera.near,
                w, full_h, kernel, radius=radius, intensity=intensity,
                rotation=rotation if band is None else None,
                samples_per_frame=spf, frame_index=ctx.frame_index,
                sample_depth=None if band is None else band.gather_rows(depth),
            )
            ao_img = ao.reshape(h, w, 1)
            halo = None if band is None else band_halo_rows(ao_img, band)
            return {"SSAO": blur3(ao_img, halo)[..., 0]}

        return execute


class LightingComposePass(RenderPass):
    name = "LightingCompose"

    def __init__(self, ddgi_grid: ddgi_ops.ProbeGridConfig | None = None):
        self.ddgi_grid = ddgi_grid

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        grid = self.ddgi_grid
        use_ddgi = grid is not None and reg.has("DDGI.irradiance")
        if use_ddgi:
            for name in DDGI_KEYS + ("SceneDepth",):
                reg.get(name)
            # Probe sampling at 1/k rate (ddgi_sample_scale, where k divides
            # the sides), nearest-depth upsampled.
            k = cfg.ddgi_sample_scale
            k = k if h % k == 0 and w % k == 0 else 1
            px, py = pixel_centers(cfg, device, step=k)
            up = torch.tensor([0.0, 1.0, 0.0], device=device)
        use_refl = reg.has("SceneReflections")
        if use_refl:
            reg.get("SceneReflections")
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
            nrm = state["SceneNormal"].reshape(-1, 3)
            if use_ddgi:
                depth = state["SceneDepth"]
                depth_s = depth[::k, ::k]
                nrm_s = state["SceneNormal"][::k, ::k].reshape(-1, 3)
                inv_vp = ssao_ops.inverse4(ctx.camera.unjittered_view_proj)
                world = ssao_ops.reconstruct_world_pos(depth_s.reshape(-1), px,
                                                       frame_rows(py, ctx), inv_vp, w, full_h)
                # Sky pixels carry zero normals, whose octahedral encode is
                # NaN: give them a unit one (their result is not used, but
                # at 1/k rate a covered pixel may take a sky cell's).
                nrm_s = torch.where(mx.vdot(nrm_s, nrm_s) > 0.25, nrm_s, up)
                ambient = ddgi_ops.sample_irradiance(ddgi_state(state), grid, world, nrm_s)
                if k > 1:
                    ambient = upsample_nearest_depth(ambient.reshape(h // k, w // k, 3),
                                                     depth_s, depth)
                else:
                    ambient = ambient.reshape(h, w, 3)
            else:
                ambient = ambient_of_normal(ctx.scene.env_map, nrm,
                                            ctx.scene.env_brightness).reshape(h, w, 3)
                ambient = (ambient + ctx.scene.lights.ambient_lx / math.pi) * ctx.camera.exposure
            ao = mat[..., 2:3]
            if use_ssao:
                ao = ao * state["SSAO"][..., None]
            diffuse = base * (1.0 - mat[..., 1:2])
            out = color + torch.where(valid, diffuse * ambient * ao, 0.0)
            if use_refl:
                out = out + torch.where(valid, state["SceneReflections"], 0.0)
            return {"SceneColor": out}

        return execute


class FogPass(RenderPass):
    name = "Fog"

    def __init__(self, density: float = 0.02, height_falloff: float = 0.05):
        self.density = density
        self.height_falloff = height_falloff

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        reg.get("SceneColor")
        reg.get("SceneDepth")
        reg.get("SceneCoverage")
        px, py = pixel_centers(cfg, device)
        density, falloff = self.density, self.height_falloff

        def execute(state: dict, ctx: FrameContext) -> dict:
            inv_vp = ssao_ops.inverse4(ctx.camera.unjittered_view_proj)
            world = ssao_ops.reconstruct_world_pos(
                state["SceneDepth"].reshape(-1), px, frame_rows(py, ctx), inv_vp, w, full_h
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

    def __init__(self, num_taps: int = 8, shutter_scale: float = 0.5,
                 temporal: bool | None = None, stochastic_taps: int = 2):
        self.num_taps = num_taps
        self.shutter_scale = shutter_scale
        self.temporal = temporal
        self.stochastic_taps = stochastic_taps

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("SceneColor")
        reg.get("SceneVelocity")
        reg.get("SceneDepth")
        temporal = temporal_of(cfg, self.temporal)
        shutter = self.shutter_scale
        taps = self.stochastic_taps if temporal else self.num_taps
        tile = 16 if cfg.height % 16 == 0 and cfg.width % 16 == 0 else 8
        if cfg.height % tile or cfg.width % tile:
            raise ValueError("motion blur needs a frame size that is a multiple of 8")

        def execute(state: dict, ctx: FrameContext) -> dict:
            out = pp.motion_blur(
                state["SceneColor"], state["SceneVelocity"], state["SceneDepth"],
                shutter_scale=shutter, num_taps=taps, tile=tile,
                stochastic=temporal, frame_index=ctx.frame_index,
            )
            return {"SceneColor": out}

        return execute


class DepthOfFieldPass(RenderPass):
    name = "DepthOfField"

    def __init__(self, num_taps: int = 24, max_coc: float = 16.0,
                 temporal: bool | None = None, stochastic_taps: int = 4):
        self.num_taps = num_taps
        self.max_coc = max_coc
        self.temporal = temporal
        self.stochastic_taps = stochastic_taps

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneDepth")
        reg.get("SceneCoverage")
        reg.create("SceneCoC", (h, w), torch.float32)
        taps, max_coc = self.num_taps, self.max_coc
        sto = self.stochastic_taps if temporal_of(cfg, self.temporal) else None

        def execute(state: dict, ctx: FrameContext) -> dict:
            coc = pp.compute_coc(
                state["SceneDepth"], state["SceneCoverage"],
                ctx.camera.near, ctx.camera.focus_depth, ctx.camera.aperture_px,
                max_coc=max_coc,
            )
            out = pp.depth_of_field(state["SceneColor"], coc, num_taps=taps,
                                    stochastic_taps=sto, frame_index=ctx.frame_index)
            return {"SceneColor": out, "SceneCoC": coc}

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
