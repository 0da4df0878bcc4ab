"""Ray-traced passes (port of arkoserenderer_tpu/rendering/passes/rt.py):
the per-frame BVH refit, RT sun shadows, RT local-light shadows and RT
reflections with their denoiser, traced through the scene's two-level BVH
(``ops/bvh.trace_rays``: the hand-written traversal kernel on the card).

  * BVHRefitPass: on a skinned or morphed scene, refits the BVH to the
    frame's deformed vertex pool and instance transforms and publishes it
    as scene.bvh; the passes after it trace that BVH
    (``scene_with_live_bvh``), the others the build-time one.

  * RTShadowPass: one any-hit ray per pixel toward the sun, off the depth
    buffer; publishes ShadowMask.sun, which replaces the sun's shadow map
    in shading. A sun with an angular radius (a soft sun) cone-samples its
    disk by blue noise (salts 13 and 14) and runs the noisy mask through
    the shadow denoiser (``ops/shadow_denoise``) over RTShadow.history /
    .moments / .depth, at full rate.
  * RTLocalShadowPass: one any-hit ray per pixel to each shadow-casting spot
    and point light, stopping just short of it; publishes
    ShadowMask.locals and ShadowMask.points (1 where a light casts none).
    A light with a source radius jitters its target on the disk facing
    the receiver (blue noise, salts 20 + 2i for spot i, 40 + 2i for point
    i); those soft planes are denoised as one stack over
    RTLocalShadow.history / .moments / .depth.
  * RTReflectionsPass: mirror rays of the surfaces under the roughness
    cutoff, shaded at their hits (``ops/rt.shade_hits``), weighted by
    Fresnel, then denoised (``ops/reflection_denoise``: prefilter,
    reproject, resolve-temporal over RTRefl.history / .moments / .depth);
    publishes SceneReflections, which LightingCompose adds. With a DDGI
    grid the hits' diffuse ambient is the probes' irradiance.

Rays of pixels that trace nothing (sky, surfaces past the cutoff) start
far below the scene, so they leave the BVH in one step. The denoisers'
guides are derived in the pass (it runs before the shading pass that
publishes SceneNormal and SceneVelocity): normals from the depth buffer's
world positions and the camera's motion.

Half-rate tracing (``PipelineConfig.rt_scale=2``, for RTShadow and
RTReflections where the sides are even and the frame is not banded):
one ray per 2x2 block, from its first pixel (centre i * 2 + 0.5, its
depth, coverage and G-buffer read with a stride of 2), a quarter of the
rays; the mask or the reflections are reconstructed to full rate by
nearest depth (``ops/image.upsample_nearest_depth``), and the denoisers
run at full rate on the full-rate depth, normals and roughness. A soft
sun draws its blue noise at the block's pixel. RTLocalShadow always
traces every pixel, as in the reference.

Under pixel-band sharding each rank traces its band's rays (frame rows,
so the blue noise of the soft shadows is the whole frame's), and the
denoisers run replicated over gathered whole-frame planes, their guides
derived from the gathered depth (their stencils clamp at the frame's
edge, not the band's); each rank then cuts its band back out. The planes
of one denoiser travel in one gather.
"""

from __future__ import annotations

import dataclasses

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.ops import brdf as brdf_ops
from arkoserenderer_torch.ops import ddgi as ddgi_ops
from arkoserenderer_torch.ops import reflection_denoise as dn
from arkoserenderer_torch.ops import shadow_denoise as sdn
from arkoserenderer_torch.ops.bvh import Hit, refit_bvh, trace_rays
from arkoserenderer_torch.ops.image import upsample_nearest_depth
from arkoserenderer_torch.ops.noise import sample_blue_noise
from arkoserenderer_torch.ops.rt import PARK, shade_hits, trace_shadow_mask
from arkoserenderer_torch.ops.ssao import inverse4, reconstruct_world_pos
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

MAX_ROUGHNESS = 0.6  # reflection rays stop past this roughness (diffuse GI takes over)


class BVHRefitPass(RenderPass):
    """Per-frame refit of an animated scene's BVH: the frame's object-space
    vertex pool (skinned and morphed by the Scene pass) through each
    vertex's instance transform, and the instances' transforms, into
    ``ops/bvh.refit_bvh``. Publishes scene.bvh."""

    name = "BVHRefit"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("geom.positions")
        reg.publish("scene.bvh")

        def execute(state: dict, ctx: FrameContext) -> dict:
            s = ctx.scene
            p = state["geom.positions"]
            m = s.world[s.vertex_instance.long()]
            wp = torch.einsum("vij,vj->vi", m[:, :3, :3], p) + m[:, :3, 3]
            return {"scene.bvh": refit_bvh(s.bvh, wp, s.indices, world=s.world)}

        return execute


def uses_live_bvh(reg: Registry) -> None:
    """Declare the read of the refitted BVH where a BVHRefitPass runs."""
    if reg.has("scene.bvh"):
        reg.get("scene.bvh")


def scene_with_live_bvh(state: dict, ctx: FrameContext):
    """The frame's scene with the refitted BVH in place of the build-time
    one, when a BVHRefitPass ran earlier in the frame."""
    bvh = state.get("scene.bvh")
    return ctx.scene if bvh is None else ctx.scene._replace(bvh=bvh)


def frame_pixel_centers(cfg: PipelineConfig, device):
    """The whole frame's pixel centres for the replicated denoisers under
    pixel-band sharding; None unsharded."""
    if cfg.shard_axis is None:
        return None
    return pixel_centers(dataclasses.replace(cfg, height=cfg.frame_height), device)


def _receivers(depth, ctx: FrameContext, px, py_g, w: int, full_h: int, covered):
    """World positions of the ``depth`` samples at ``px``, ``py_g`` (frame
    rows), and the same with the uncovered ones parked."""
    inv_vp = inverse4(ctx.camera.unjittered_view_proj)
    world = reconstruct_world_pos(depth.reshape(-1), px, py_g, inv_vp, w, full_h)
    return world, torch.where(covered[:, None], world, PARK)


def rt_rate(cfg: PipelineConfig) -> int:
    """The ray-tracing rate of RTShadow and RTReflections: ``rt_scale``
    where the band's sides are even and the frame is not banded, else 1."""
    even = cfg.height % 2 == 0 and cfg.width % 2 == 0
    return cfg.rt_scale if cfg.shard_axis is None and even else 1


def _denoised(noisy, world, state: dict, ctx: FrameContext, px, py, w: int, h: int,
              prefix: str, frame_px=None) -> dict:
    """The shadow denoiser over the (H, W, C) noisy planes, its guides
    derived from the unparked world positions; returns the resolved planes
    and the new ``prefix``.history / .moments / .depth. Under pixel-band
    sharding it runs on the gathered frame (``frame_px``: the frame's
    pixel centres), guides from the gathered depth, and keeps the band."""
    depth = state["SceneDepth"]
    planes = (noisy, state[f"{prefix}.history"], state[f"{prefix}.moments"],
              state[f"{prefix}.depth"])
    band = ctx.band
    if band is not None:
        depth_in = depth
        depth, *planes = band.gather_rows_many(depth, *planes)
        px, py = frame_px
        h = depth.shape[0]
        world = reconstruct_world_pos(depth.reshape(-1), px, py,
                                      inverse4(ctx.camera.unjittered_view_proj), w, h)
    world_img = world.reshape(h, w, 3)
    normal = sdn.normals_from_depth(world_img)
    vel = sdn.camera_velocity(world_img, px, py, ctx.camera.prev_view_proj, w, h)
    resolved, mom = sdn.denoise(planes[0], depth, normal, vel, *planes[1:], px, py,
                                ctx.frame_index == 0)
    if band is not None:
        resolved, mom, depth = band.band_rows(resolved), band.band_rows(mom), depth_in
    return {f"{prefix}.history": resolved, f"{prefix}.moments": mom, f"{prefix}.depth": depth}


def _soft_state(reg: Registry, prefix: str, h: int, w: int, c: int) -> None:
    """The persistent state of a denoised stack of ``c`` planes."""
    reg.create(f"{prefix}.history", (h, w, c), torch.float32, persistent=True)
    reg.create(f"{prefix}.moments", (h, w, 2 * c + 1), torch.float32, persistent=True)
    reg.create(f"{prefix}.depth", (h, w), torch.float32, persistent=True)


class RTShadowPass(RenderPass):
    """Per-pixel any-hit sun shadow mask (replaces the sun's shadow map);
    with a soft sun, a blue-noise cone sample of its disk, denoised."""

    name = "RTShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        reg.get("SceneDepth")
        reg.get("Visibility")
        uses_live_bvh(reg)
        soft = cfg.scene.sun_angular_radius_deg > 0.0
        if soft:
            _soft_state(reg, "RTShadow", h, w, 1)
        reg.create("ShadowMask.sun", (h, w), torch.float32, clear=1.0)
        scale = rt_rate(cfg)
        px_full, py_full = pixel_centers(cfg, device)
        px, py = pixel_centers(cfg, device, step=scale) if scale > 1 else (px_full, py_full)
        full_h = cfg.frame_height
        frame_px = frame_pixel_centers(cfg, device) if soft else None

        def execute(state: dict, ctx: FrameContext) -> dict:
            depth = state["SceneDepth"]
            depth_s = depth[::scale, ::scale]
            covered = state["Visibility"][::scale, ::scale].reshape(-1) >= 0
            py_g = frame_rows(py, ctx)
            world, parked = _receivers(depth_s, ctx, px, py_g, w, full_h, covered)
            lights = ctx.scene.lights
            light_dir = -lights.sun_direction
            if soft:
                u1 = sample_blue_noise(px, py_g, ctx.frame_index, salt=13)
                u2 = sample_blue_noise(px, py_g, ctx.frame_index, salt=14)
                light_dir = mx.sample_cone(light_dir[None, :], lights.sun_cos_radius, u1, u2)
            mask = trace_shadow_mask(scene_with_live_bvh(state, ctx), parked, light_dir,
                                     covered, label="sun mask")
            if scale > 1:
                mask = upsample_nearest_depth(mask.reshape(h // scale, w // scale, 1), depth_s,
                                              depth)[..., 0]
                if soft:  # the denoiser's guides come from the full-rate depth
                    world = reconstruct_world_pos(
                        depth.reshape(-1), px_full, frame_rows(py_full, ctx),
                        inverse4(ctx.camera.unjittered_view_proj), w, full_h)
            else:
                mask = mask.reshape(h, w)
            if not soft:
                return {"ShadowMask.sun": mask}
            out = _denoised(mask[..., None], world, state, ctx, px_full, py_full, w, h,
                            "RTShadow", frame_px)
            return {"ShadowMask.sun": out["RTShadow.history"][..., 0], **out}

        return execute


class RTLocalShadowPass(RenderPass):
    """Per-pixel any-hit shadow masks of the local lights: one (H, W) plane
    per spot and per point light, traced to the light with t_max just short
    of it; lights that cast no shadow keep a plane of ones. Which lights
    cast, and their source radii, come from ``cfg.scene``; a casting light
    with a radius is soft: disk-jittered, and denoised with the others."""

    name = "RTLocalShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        st = cfg.scene
        spot_casters, point_casters = st.spot_shadow_casters, st.point_shadow_casters

        def radii(casters, source_radius):
            return tuple(float(source_radius[i]) if i < len(source_radius) else 0.0
                         for i in range(len(casters)))

        spot_radii = radii(spot_casters, st.spot_source_radius)
        point_radii = radii(point_casters, st.point_source_radius)
        # The soft planes, in the denoised stack's order: ("spot" | "point", i).
        soft_channels = (
            [("spot", i) for i, c in enumerate(spot_casters) if c and spot_radii[i] > 0.0]
            + [("point", i) for i, c in enumerate(point_casters) if c and point_radii[i] > 0.0])
        h, w = cfg.height, cfg.width
        reg.get("SceneDepth")
        reg.get("Visibility")
        uses_live_bvh(reg)
        if soft_channels:
            _soft_state(reg, "RTLocalShadow", h, w, len(soft_channels))
        n_s, n_p = len(spot_casters), len(point_casters)
        reg.create("ShadowMask.locals", (max(n_s, 1), h, w), torch.float32, clear=1.0)
        reg.create("ShadowMask.points", (max(n_p, 1), h, w), torch.float32, clear=1.0)
        px, py = pixel_centers(cfg, device)
        full_h = cfg.frame_height
        frame_px = frame_pixel_centers(cfg, device) if soft_channels else None

        def execute(state: dict, ctx: FrameContext) -> dict:
            covered = state["Visibility"].reshape(-1) >= 0
            py_g = frame_rows(py, ctx)
            world, parked = _receivers(state["SceneDepth"], ctx, px, py_g, w, full_h, covered)
            bvh = scene_with_live_bvh(state, ctx).bvh

            def mask_to(light_pos, label, radius=0.0, salt=0):
                to_l = light_pos[None, :] - parked
                dist = torch.sqrt(torch.clamp(mx.vdot(to_l, to_l), min=1e-12))
                l_dir = to_l / dist
                if radius > 0.0:
                    # The light's position jittered on the disk facing the
                    # receiver (a spherical source's occlusion).
                    u1 = sample_blue_noise(px, py_g, ctx.frame_index, salt=salt)
                    u2 = sample_blue_noise(px, py_g, ctx.frame_index, salt=salt + 1)
                    to_l = to_l + mx.sample_disk_offset(l_dir, radius, u1, u2)
                    dist = torch.sqrt(torch.clamp(mx.vdot(to_l, to_l), min=1e-12))
                    l_dir = to_l / dist
                occ = trace_rays(bvh, parked + l_dir * 3e-2, l_dir.contiguous(),
                                 t_max=torch.clamp(dist[:, 0] - 6e-2, min=1e-3), any_hit=True,
                                 label=label)
                return torch.where(covered, (~occ.hit).to(torch.float32), 1.0).reshape(h, w)

            ones = torch.ones((h, w), dtype=torch.float32, device=world.device)
            lights = ctx.scene.lights
            planes = {
                "spot": [mask_to(lights.spot_pos[i], f"spot mask {i}", spot_radii[i], 20 + 2 * i)
                         if cast else ones for i, cast in enumerate(spot_casters)] or [ones],
                "point": [mask_to(lights.point_pos[i], f"point mask {i}", point_radii[i],
                                  40 + 2 * i)
                          if cast else ones for i, cast in enumerate(point_casters)] or [ones],
            }
            out = {}
            if soft_channels:
                noisy = torch.stack([planes[kind][i] for kind, i in soft_channels], dim=-1)
                out = _denoised(noisy, world, state, ctx, px, py, w, h, "RTLocalShadow",
                                frame_px)
                for ci, (kind, i) in enumerate(soft_channels):
                    planes[kind][i] = out["RTLocalShadow.history"][..., ci]
            return {"ShadowMask.locals": torch.stack(planes["spot"]),
                    "ShadowMask.points": torch.stack(planes["point"]), **out}

        return execute


class RTReflectionsPass(RenderPass):
    """RT reflections: a mirror ray per pixel (per 2x2 block at
    ``rt_scale=2``) under MAX_ROUGHNESS, shaded at its hit, Fresnel-weighted
    (faded out over the last quarter before the cutoff), reconstructed to
    full rate by nearest depth at half rate, and denoised at full rate:
    prefilter, reprojection and temporal resolve (the reference's defaults;
    its roughness and temporal knobs have no caller). With ``ddgi_grid`` and
    the DDGI pass earlier in the frame, the hits sample the probes for their
    diffuse ambient."""

    name = "RTReflections"

    def __init__(self, ddgi_grid: ddgi_ops.ProbeGridConfig | None = None):
        self.ddgi_grid = ddgi_grid

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        h, w = cfg.height, cfg.width
        for name in ("SceneDepth", "SceneNormal", "SceneMaterial", "SceneBaseColor",
                     "SceneCoverage"):
            reg.get(name)
        grid = self.ddgi_grid
        use_ddgi = grid is not None and reg.has("DDGI.irradiance")
        if use_ddgi:
            for name in DDGI_KEYS:
                reg.get(name)
        uses_live_bvh(reg)
        reg.create("SceneReflections", (h, w, 3), torch.float32)
        reg.get("SceneVelocity")
        reg.create("RTRefl.history", (h, w, 3), torch.float32, persistent=True)
        reg.create("RTRefl.moments", (h, w, 3), torch.float32, persistent=True)
        reg.create("RTRefl.depth", (h, w), torch.float32, persistent=True)
        scale = rt_rate(cfg)
        px_full, py_full = pixel_centers(cfg, device)
        px, py = pixel_centers(cfg, device, step=scale) if scale > 1 else (px_full, py_full)
        full_h = cfg.frame_height
        frame_px = frame_pixel_centers(cfg, device)
        # Ray cone ~ one traced pixel of the vertical FOV.
        cone_spread = scale / max(full_h, 1)
        n_rays = (h // scale) * (w // scale)
        compact = n_rays >= (1 << 17)  # the reference compacts where it traces in chunks
        st = cfg.scene

        def execute(state: dict, ctx: FrameContext) -> dict:
            live = scene_with_live_bvh(state, ctx)
            depth = state["SceneDepth"]
            depth_s = depth[::scale, ::scale]
            valid0 = state["SceneCoverage"][::scale, ::scale].reshape(-1)
            inv_vp = inverse4(ctx.camera.unjittered_view_proj)
            world = reconstruct_world_pos(depth_s.reshape(-1), px, frame_rows(py, ctx), inv_vp,
                                          w, full_h)
            world = torch.where(valid0[:, None], world, PARK)
            nrm = state["SceneNormal"][::scale, ::scale].reshape(-1, 3)
            mat = state["SceneMaterial"][::scale, ::scale].reshape(-1, 4)
            base = state["SceneBaseColor"][::scale, ::scale].reshape(-1, 3)
            rough = mat[:, 0:1]
            metal = mat[:, 1:2]

            view = mx.normalize(ctx.camera.position[None, :] - world)
            r_dir = mx.normalize(mx.reflect(-view, nrm))
            active = valid0 & (rough[:, 0] < MAX_ROUGHNESS)
            world = torch.where(active[:, None], world, PARK)
            origins = world + nrm * 2e-2
            if compact:
                # The active rays first, in pixel order (a stable sort), so
                # neighbouring threads walk neighbouring rays; the result of
                # each ray does not change.
                order = torch.argsort((~active).to(torch.uint8), stable=True)
                hit_s = trace_rays(live.bvh, origins[order], r_dir[order], t_max=1e4,
                                   label="reflection")
                inv = torch.empty_like(order)
                inv[order] = torch.arange(n_rays, device=order.device)
                hit = Hit(*(x[inv] for x in hit_s))
            else:
                hit = trace_rays(live.bvh, origins, r_dir.contiguous(), t_max=1e4,
                                 label="reflection")
            ddgi_sample = None
            if use_ddgi:
                probes = ddgi_state(state)

                def ddgi_sample(wp, n):
                    return ddgi_ops.sample_irradiance(probes, grid, wp, n)

            radiance = shade_hits(live, hit, r_dir, ctx.camera.exposure,
                                  cone_spread=cone_spread, ddgi_sample=ddgi_sample,
                                  n_spots=st.n_spots,
                                  n_points=st.n_points, spot_casters=st.spot_shadow_casters,
                                  point_casters=st.point_shadow_casters)

            f0 = brdf_ops.base_f0(base, metal)
            n_dot_v = torch.clamp(mx.vdot(nrm, view), 0.0, 1.0)
            fresnel = brdf_ops.env_fresnel_roughness(n_dot_v, f0, rough)
            fade = torch.clamp((MAX_ROUGHNESS - rough) / (0.25 * MAX_ROUGHNESS), 0.0, 1.0)
            refl = torch.where(active[:, None], radiance * fresnel * fade, 0.0)
            if scale > 1:
                # Reconstructed to full rate; the denoiser's guides are the
                # full-rate G-buffer's.
                refl_img = upsample_nearest_depth(refl.reshape(h // scale, w // scale, 3),
                                                  depth_s, depth)
                rough_img, nrm_img = state["SceneMaterial"][..., 0:1], state["SceneNormal"]
            else:
                refl_img = refl.reshape(h, w, 3)
                rough_img, nrm_img = rough.reshape(h, w, 1), nrm.reshape(h, w, 3)
            planes = (refl_img, rough_img, nrm_img, depth, state["RTRefl.history"],
                      state["RTRefl.moments"], state["RTRefl.depth"], state["SceneVelocity"])
            dpx, dpy, band = px_full, py_full, ctx.band
            if band is not None:
                # The denoiser runs replicated on the gathered frame.
                planes = band.gather_rows_many(*planes)
                dpx, dpy = frame_px
            refl_i, rough_i, nrm_i, depth_i, hist_i, mom_i, prev_depth, vel = planes
            filtered = dn.prefilter(refl_i, rough_i, nrm_i, depth_i)
            hist, mom, conf = dn.reproject(hist_i, mom_i, prev_depth, depth_i, vel, dpx, dpy)
            resolved, moments = dn.resolve_temporal(filtered, hist, mom, conf,
                                                    ctx.frame_index == 0)
            if band is not None:
                resolved, moments = band.band_rows(resolved), band.band_rows(moments)
            return {"SceneReflections": resolved, "RTRefl.history": resolved,
                    "RTRefl.moments": moments, "RTRefl.depth": depth}

        return execute
