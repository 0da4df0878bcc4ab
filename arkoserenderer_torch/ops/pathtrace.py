"""Progressive path tracer over the scene's two-level BVH (port of
arkoserenderer_tpu/ops/pathtrace.py: ``_onb``, ``_cosine_sample``,
``_surface_at_hit``, ``_material_at``, ``SUN_COS`` and ``trace_path``).

One sample a pixel per call: a wavefront of camera rays, then ``max_bounces``
bounces of GGX + Lambert transport chosen by one-sample MIS, with
next-event estimation toward the sun and each local light (an any-hit
occlusion ray each: cone-sampled over a soft sun's disk, disk-jittered
toward a light with a source radius), the environment on a miss, and the
materials sampled from the RGBA8 pool (``ops/texture``) at a ray-cone mip.
Every lane is traced and shaded every bounce and the dead ones are masked,
as the reference does. Rays go through ``ops/bvh.trace_rays`` (the
traversal kernel on the card), each trace labelled "pt ray b", "pt sun b",
"pt spot i b" or "pt point i b" with b the bounce and i the light. The
random numbers are JAX's (``core/prng`` on the device), split in the
reference's order, so a sample equals the reference's for the same key.
"""

from __future__ import annotations

import math

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core import prng
from arkoserenderer_torch.ops import brdf
from arkoserenderer_torch.ops import texture as tx
from arkoserenderer_torch.ops.bvh import Hit, trace_rays
from arkoserenderer_torch.ops.envmap import sample_equirect
from arkoserenderer_torch.ops.rt import surface_at_hits
from arkoserenderer_torch.ops.ssao import inverse4

SUN_COS = 0.9999  # ~0.8 degree solid-angle sun for NEE


def _onb(n: torch.Tensor):
    """Branchless orthonormal basis of (R, 3) unit normals."""
    return mx.onb(n)


def _cosine_sample(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    t, b = _onb(n)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = (r * torch.cos(phi))[:, None]
    y = (r * torch.sin(phi))[:, None]
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))[:, None]
    return mx.normalize(x * t + y * b + z * n)


def _surface_at_hit(scene, hit_tri, hit_u, hit_v):
    """World position, normal, uv, material id and sqrt(uv area / world
    area) (the uv length per world unit that turns a ray cone's radius into
    a texture footprint) at the hits."""
    return surface_at_hits(scene, Hit(t=None, tri=hit_tri, u=hit_u, v=hit_v, hit=None),
                           with_uv_density=True)


def _material_at(scene, mat_id, uv, footprint):
    """Base colour, roughness, metallic, emissive, clearcoat and clearcoat
    roughness at ``uv``; ``footprint`` (R,) is the ray cone's uv-space
    diameter at the hit, so each texture's LOD is log2(footprint * its
    resolution)."""
    m = scene.materials
    mat_id = mat_id.long()

    def lod_for(tex_id):
        size0 = scene.textures.mip_size[tex_id.long(), 0].to(torch.float32).amax(-1)
        return torch.log2(torch.clamp(footprint * size0, min=1e-6))

    base_id = m.base_color_tex[mat_id]
    base_tex = tx.sample_trilinear(scene.textures, base_id, uv, lod_for(base_id))
    base = base_tex[:, :3] * m.base_color_factor[mat_id][:, :3]
    mr_id = m.mr_tex[mat_id]
    mr = tx.sample_trilinear(scene.textures, mr_id, uv, lod_for(mr_id), decode_srgb=False)
    rough = torch.clamp(mr[:, 1:2] * m.roughness_factor[mat_id][:, None], 0.05, 1.0)
    metal = torch.clamp(mr[:, 2:3] * m.metallic_factor[mat_id][:, None], 0.0, 1.0)
    emissive = m.emissive_factor[mat_id]
    cc = m.clearcoat[mat_id][:, None]
    cc_rough = m.clearcoat_roughness[mat_id][:, None]
    return base, rough, metal, emissive, cc, cc_rough


def _split(key: torch.Tensor, n: int = 2):
    return tuple(prng.split(key, n).unbind(0))


def _occlusion(bvh, origins, to_l, radius: float, key, r: int, label: str):
    """Any-hit occlusion toward a local light ``to_l`` away (R, 3), stopping
    2 mm short of it; with a source radius the target is jittered on the
    disk facing the receiver (and ``key`` split). Returns (hit, key)."""
    dist = torch.sqrt(torch.clamp(mx.vdot(to_l, to_l), min=1e-6))
    occ_dir, occ_tmax = to_l / dist, (dist - 2e-3)[:, 0]
    if radius > 0.0:
        k_l, key = _split(key)
        ul = prng.uniform(k_l, (r, 2))
        to_j = to_l + mx.sample_disk_offset(to_l / dist, radius, ul[:, 0], ul[:, 1])
        d_j = torch.sqrt(torch.clamp(mx.vdot(to_j, to_j), min=1e-6))
        occ_dir, occ_tmax = to_j / d_j, (d_j - 2e-3)[:, 0]
    hit = trace_rays(bvh, origins, occ_dir.contiguous(), t_max=occ_tmax, any_hit=True,
                     label=label).hit
    return hit, key


def trace_path(scene, bvh, cam, px: torch.Tensor, py: torch.Tensor, width: int, height: int,
               key: torch.Tensor, max_bounces: int = 3, aa: bool = True, n_spots: int = 0,
               n_points: int = 0, spot_casters: tuple = (), point_casters: tuple = (),
               sun_cos_radius: float = 1.0, spot_source_radius: tuple = (),
               point_source_radius: tuple = ()) -> torch.Tensor:
    """One sample a pixel of pre-exposed radiance, (R, 3), for the pixel
    centres ``px``, ``py`` (R,) under ``key`` (a (2,) int64 key tensor,
    ``core/prng``). ``n_spots`` / ``n_points`` local lights get NEE;
    ``*_casters`` say which of them cast shadows (one the raster leaves
    unshadowed is unshadowed here too; a light past the tuple casts);
    ``sun_cos_radius`` < 1 is a soft sun and a source radius > 0 a soft
    light."""
    r = px.shape[0]
    dev = px.device
    exposure = cam.exposure

    k_aa, key = _split(key)
    jitter = (prng.uniform(k_aa, (r, 2)) - 0.5) if aa else torch.zeros((r, 2), device=dev)

    inv_vp = inverse4(cam.unjittered_view_proj)
    ndc_x = (px + jitter[:, 0]) / width * 2.0 - 1.0
    ndc_y = (0.5 - (py + jitter[:, 1]) / height) * 2.0
    target_h = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, 0.5), torch.ones_like(ndc_x)],
                           dim=-1) @ inv_vp.T
    den = target_h[:, 3:4]
    inv = torch.where(torch.abs(den) > 1e-10, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    target = target_h[:, :3] * inv
    origins = cam.position.expand(r, 3)
    dirs = mx.normalize(target - origins)

    radiance = torch.zeros((r, 3), device=dev)
    throughput = torch.ones((r, 3), device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)

    # Ray-cone LOD: a pixel subtends ~2 / (P11 * height) radians, and the
    # cone's radius grows with the distance the path has travelled, so
    # primary hits mip-filter as the raster's screen derivatives do.
    cone_spread = 2.0 / (torch.abs(cam.unjittered_proj[1, 1]) * height)
    cone_t = torch.zeros((r,), device=dev)

    lights = scene.lights
    sun_l = -lights.sun_direction
    sun_radiance = lights.sun_color * exposure

    for bounce in range(max_bounces + 1):
        hit = trace_rays(bvh, origins.contiguous(), dirs.contiguous(), label=f"pt ray {bounce}")
        cone_t = cone_t + torch.where(hit.hit, hit.t, 0.0)

        # Miss: the environment.
        env = sample_equirect(scene.env_map, dirs) * scene.env_brightness * exposure
        radiance = radiance + torch.where((alive & ~hit.hit)[:, None], throughput * env, 0.0)
        alive = alive & hit.hit
        if bounce == max_bounces:
            break

        world_pos, n, uv, mat_id, uv_density = _surface_at_hit(
            scene, torch.clamp(hit.tri, min=0), hit.u, hit.v)
        # The cone's footprint stretches by 1/cos(incidence) along its long
        # axis, which the mip keys on (as the raster's max-gradient rho).
        grazing = torch.clamp(torch.abs(mx.vdot(n, dirs, keepdims=False)), min=0.05)
        footprint = torch.clamp(cone_t * cone_spread, min=1e-6) * uv_density / grazing
        base, rough, metal, emissive, cc, cc_rough = _material_at(scene, mat_id, uv, footprint)
        n = n * torch.where(mx.vdot(n, -dirs) < 0.0, -1.0, 1.0)  # face the incoming ray

        radiance = radiance + torch.where(alive[:, None], throughput * emissive * exposure, 0.0)
        view = -dirs

        # Next-event estimation, the sun: a soft sun's occlusion ray
        # cone-samples its disk (shading stays at the central direction).
        shadow_org = (world_pos + n * 1e-3).contiguous()
        if sun_cos_radius < 1.0:
            k_sun, key = _split(key)
            us = prng.uniform(k_sun, (r, 2))
            sun_occ_dir = mx.sample_cone(sun_l[None, :], sun_cos_radius, us[:, 0], us[:, 1])
        else:
            sun_occ_dir = sun_l.expand(r, 3)
        occl = trace_rays(bvh, shadow_org, sun_occ_dir.contiguous(), any_hit=True,
                          label=f"pt sun {bounce}")
        fr_sun = brdf.evaluate(sun_l.expand(r, 3), view, n, base, rough, metal, cc, cc_rough)
        lit = alive & ~occl.hit
        radiance = radiance + torch.where(
            lit[:, None], throughput * fr_sun * sun_radiance * lights.sun_valid, 0.0)

        # Local lights: the raster's radiometry (cone^2 * IES / d^2 for a
        # spot, 1 / d^2 for a point) behind exact occlusion rays.
        no_hit = torch.zeros((r,), dtype=torch.bool, device=dev)
        for li in range(n_spots):
            to_l = lights.spot_pos[li][None, :] - world_pos
            dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
            l_dir = to_l / torch.sqrt(dist2)
            occ_hit = no_hit
            if li >= len(spot_casters) or spot_casters[li]:
                radius = spot_source_radius[li] if li < len(spot_source_radius) else 0.0
                occ_hit, key = _occlusion(bvh, shadow_org, to_l, radius, key, r,
                                          f"pt spot {li} {bounce}")
            cos_dir = -mx.vdot(l_dir, lights.spot_dir[li][None, :], keepdims=False)
            cone = lights.spot_cone[li]
            tt = torch.clamp((cos_dir - cone[1]) / torch.clamp(cone[0] - cone[1], min=1e-4),
                             0.0, 1.0)
            angle_idx = torch.clamp(
                (torch.acos(torch.clamp(cos_dir, -1.0, 1.0)) / math.pi * 255.0).to(torch.int32),
                0, 255).long()
            falloff = tt * tt * lights.spot_ies[li][angle_idx] / dist2[:, 0]
            fr = brdf.evaluate(l_dir, view, n, base, rough, metal, cc, cc_rough)
            radiance = radiance + torch.where(
                (alive & ~occ_hit)[:, None],
                throughput * fr * (lights.spot_color[li][None, :] * exposure) * falloff[:, None],
                0.0)
        for li in range(n_points):
            to_l = lights.point_pos[li][None, :] - world_pos
            dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
            l_dir = to_l / torch.sqrt(dist2)
            occ_hit = no_hit
            if li >= len(point_casters) or point_casters[li]:
                radius = point_source_radius[li] if li < len(point_source_radius) else 0.0
                occ_hit, key = _occlusion(bvh, shadow_org, to_l, radius, key, r,
                                          f"pt point {li} {bounce}")
            fr = brdf.evaluate(l_dir, view, n, base, rough, metal, cc, cc_rough)
            radiance = radiance + torch.where(
                (alive & ~occ_hit)[:, None],
                throughput * fr * (lights.point_color[li][None, :] * exposure) / dist2, 0.0)

        # The continuation: cosine-weighted diffuse or a GGX visible-normal
        # half vector, picked with probability by metalness.
        k1, k2, k3, key = _split(key, 4)
        u1 = prng.uniform(k1, (r,))
        u2 = prng.uniform(k2, (r,))
        p_spec = 0.5 * metal[:, 0] + 0.04
        pick_spec = prng.uniform(k3, (r,)) < p_spec

        d_diff = _cosine_sample(n, u1, u2)  # f * cos / pdf = albedo
        w_diff = base * (1.0 - metal)

        t, b = _onb(n)
        v_ts = torch.stack([mx.vdot(view, t, False), mx.vdot(view, b, False),
                            mx.vdot(view, n, False)], dim=-1)
        h_ts = brdf.sample_ggx_vndf(v_ts, (rough * rough)[:, 0], u1, u2)
        h_w = h_ts[:, 0:1] * t + h_ts[:, 1:2] * b + h_ts[:, 2:3] * n
        d_spec = mx.normalize(mx.reflect(dirs, h_w))
        f0 = brdf.base_f0(base, metal)
        n_dot_l = torch.clamp(mx.vdot(n, d_spec), 0.0, 1.0)
        # The VNDF weight: F times the outgoing direction's Smith term ~ 1.
        w_spec = brdf.f_schlick(torch.clamp(mx.vdot(view, h_w), 0.0, 1.0), f0) * torch.where(
            n_dot_l > 0.0, 1.0, 0.0)

        dirs = torch.where(pick_spec[:, None], d_spec, d_diff)
        contrib = torch.where(pick_spec[:, None], w_spec, w_diff)
        p = torch.where(pick_spec, p_spec, 1.0 - p_spec)
        throughput = throughput * contrib / torch.clamp(p, min=1e-3)[:, None]
        origins = shadow_org
        alive = alive & (mx.vdot(n, dirs, False) > 0.0)  # no ray below the surface
        throughput = torch.where(alive[:, None], throughput, 0.0)

    return radiance
