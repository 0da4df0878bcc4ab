"""Ray-traced shading helpers of the screen-space RT passes (port of
arkoserenderer_tpu/ops/rt.py: ``surface_at_hits``, ``shade_hits_simple``,
``shade_hits`` and ``trace_shadow_mask``).

Given BVH hits, reconstruct the surface (position, normal, uv, material)
and shade it as the reflection rays' closest-hit shader does: the packed
material at a ray-cone mip, the Filament BRDF for the sun and the local
lights with an any-hit occlusion ray each, emissive, the diffuse ambient
(the DDGI probes' irradiance when the frame has them, else the flat
environment ambient), and the environment on a miss. Rays of misses are parked far
below the scene, so their occlusion rays leave the BVH in one step.
"""

from __future__ import annotations

import math

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.ops import brdf as brdf_ops
from arkoserenderer_torch.ops import mattex
from arkoserenderer_torch.ops.bvh import Hit, trace_rays
from arkoserenderer_torch.ops.envmap import ambient_of_normal, sample_equirect
from arkoserenderer_torch.ops.packed_shading import M_BASEF, M_EMIF, M_METAL, M_ROUGH, M_TEXMETA

PARK = -1e7  # origin of a ray that must leave the BVH in one step


def _bary_mix(bary: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """sum_k bary[:, k] corners[:, k] over the 3 corners of (R, 3, C)."""
    return (bary[:, 0:1] * corners[:, 0] + bary[:, 1:2] * corners[:, 1]
            + bary[:, 2:3] * corners[:, 2])


def _mat3_apply(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(R, 3, 3+) matrices times (R, 3) vectors, the 3x3 part."""
    return m[:, :3, 0] * p[:, 0:1] + m[:, :3, 1] * p[:, 1:2] + m[:, :3, 2] * p[:, 2:3]


def surface_at_hits(scene, hit: Hit, with_uv_density: bool = False):
    """World position, normal, uv and material id at the hit points; with
    ``with_uv_density`` also sqrt(uv area / world area) of the hit
    triangle, which turns a ray-cone radius into a texture footprint."""
    tri = torch.clamp(hit.tri, min=0).long()
    corners = scene.indices[tri].long()          # (R, 3)
    inst = scene.tri_instance[tri].long()
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    p = scene.positions[corners]                 # (R, 3, 3) object space
    w_m = scene.world[inst]
    world_pos = _mat3_apply(w_m, _bary_mix(bary, p)) + w_m[:, :3, 3]
    nrm = mx.normalize(_mat3_apply(scene.normal_mat[inst], _bary_mix(bary, scene.normals[corners])))
    t_uv = scene.uvs[corners]
    uv = _bary_mix(bary, t_uv)
    mat_id = scene.inst_material[inst]
    if not with_uv_density:
        return world_pos, nrm, uv, mat_id
    e1w = _mat3_apply(w_m, p[:, 1] - p[:, 0])
    e2w = _mat3_apply(w_m, p[:, 2] - p[:, 0])
    area_w = 0.5 * torch.linalg.vector_norm(torch.cross(e1w, e2w, dim=-1), dim=-1)
    e1u = t_uv[:, 1] - t_uv[:, 0]
    e2u = t_uv[:, 2] - t_uv[:, 0]
    area_uv = 0.5 * torch.abs(e1u[:, 0] * e2u[:, 1] - e1u[:, 1] * e2u[:, 0])
    return world_pos, nrm, uv, mat_id, torch.sqrt(area_uv / torch.clamp(area_w, min=1e-12))


def shade_hits_simple(scene, hit: Hit, ray_dirs: torch.Tensor, exposure,
                      ddgi_sample=None) -> torch.Tensor:
    """(R, 3) pre-exposed radiance, the reference's simple hit shader: at a
    hit the material's base colour lit diffusely by the sun behind one
    any-hit occlusion ray (through ``trace_rays``, labelled "simple
    occlusion"), its emissive, and ``ddgi_sample(world_pos, normal)`` (an
    irradiance) times the albedo when given; the environment on a miss."""
    world_pos, nrm, _, mat_id = surface_at_hits(scene, hit)
    nrm = nrm * torch.where(mx.vdot(nrm, -ray_dirs) < 0.0, -1.0, 1.0)
    mat = mat_id.long()
    albedo = scene.materials.base_color_factor[mat][:, :3]
    emissive = scene.materials.emissive_factor[mat]

    lights = scene.lights
    sun_l = -lights.sun_direction
    hit_col = hit.hit[:, None]
    occl = trace_rays(scene.bvh, torch.where(hit_col, world_pos + nrm * 1e-2, PARK),
                      sun_l.expand_as(world_pos).contiguous(), any_hit=True, t_max=1e4,
                      label="simple occlusion")
    n_dot_l = torch.clamp(mx.vdot(nrm, sun_l[None, :], keepdims=False), 0.0, 1.0)
    color = (albedo / math.pi * (lights.sun_color * exposure)[None, :]
             * (n_dot_l * (~occl.hit))[:, None] * lights.sun_valid) + emissive * exposure
    if ddgi_sample is not None:
        color = color + ddgi_sample(world_pos, nrm) * albedo / math.pi

    env = sample_equirect(scene.env_map, ray_dirs) * scene.env_brightness * exposure
    return torch.where(hit_col, color, env)


def shade_hits(scene, hit: Hit, ray_dirs: torch.Tensor, exposure,
               cone_spread: float = 2e-3, ddgi_sample=None, n_spots: int = 0,
               n_points: int = 0, spot_casters: tuple = (),
               point_casters: tuple = ()) -> torch.Tensor:
    """(R, 3) pre-exposed radiance of the reflection rays: at a hit the
    textured material (nearest mip of the ray-cone footprint), the sun and
    the first ``n_spots`` / ``n_points`` local lights through the BRDF,
    each behind an any-hit occlusion ray where it casts shadows, emissive
    and the diffuse ambient: ``ddgi_sample(world_pos, normal)`` (the
    probes' irradiance) when given, else the flat environment ambient; the
    environment on a miss. Every lane samples; a miss's garbage never
    reaches the result (a select, not a multiply by a mask)."""
    world_pos, nrm, uv, mat_id, uv_density = surface_at_hits(scene, hit, with_uv_density=True)
    nrm = nrm * torch.where(mx.vdot(nrm, -ray_dirs) < 0.0, -1.0, 1.0)
    mrec = scene.mat_records[mat_id.long()]

    # Ray-cone footprint: cone radius at the hit times uv per world unit.
    t_hit = hit.t * torch.linalg.vector_norm(ray_dirs, dim=-1)
    footprint = torch.clamp(t_hit * cone_spread, min=1e-6) * uv_density
    duv = torch.stack([footprint, torch.zeros_like(footprint)], dim=-1)
    ms = mattex.sample_packed(scene.mat_tex.rows, mrec[:, M_TEXMETA:M_TEXMETA + mattex.META_LANES],
                              uv, duv, duv.flip(-1), quality="bilinear")
    base = ms.base[:, :3] * mrec[:, M_BASEF:M_BASEF + 3]
    rough = torch.clamp(ms.rough_metal[:, 0:1] * mrec[:, M_ROUGH:M_ROUGH + 1], 0.0, 1.0)
    metal = torch.clamp(ms.rough_metal[:, 1:2] * mrec[:, M_METAL:M_METAL + 1], 0.0, 1.0)
    emissive = ms.emissive * mrec[:, M_EMIF:M_EMIF + 3]

    lights = scene.lights
    sun_l = -lights.sun_direction
    hit_col = hit.hit[:, None]
    occl_org = torch.where(hit_col, world_pos + nrm * 1e-2, PARK)
    occl = trace_rays(scene.bvh, occl_org, sun_l.expand_as(world_pos).contiguous(),
                      any_hit=True, t_max=1e4, label="sun occlusion")
    view = -mx.normalize(ray_dirs)
    fr = brdf_ops.evaluate(sun_l.expand_as(nrm), view, nrm, base, rough, metal)
    color = (fr * (lights.sun_color * exposure)[None, :] * (~occl.hit)[:, None]
             * lights.sun_valid) + emissive * exposure

    for li in range(n_spots):
        to_l = lights.spot_pos[li][None, :] - world_pos
        dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
        dist = torch.sqrt(dist2)
        l_dir = to_l / dist
        cos_dir = -mx.vdot(l_dir, lights.spot_dir[li][None, :], keepdims=False)
        cone = lights.spot_cone[li]
        tt = torch.clamp((cos_dir - cone[1]) / torch.clamp(cone[0] - cone[1], min=1e-4), 0.0, 1.0)
        angle_idx = torch.clamp(
            (torch.acos(torch.clamp(cos_dir, -1.0, 1.0)) / math.pi * 255.0).to(torch.int64),
            0, 255)
        falloff = tt * tt * lights.spot_ies[li][angle_idx] / dist2[:, 0]
        if li >= len(spot_casters) or spot_casters[li]:
            occ_l = trace_rays(scene.bvh, occl_org, l_dir.contiguous(),
                               t_max=torch.clamp(dist[:, 0] - 6e-2, min=1e-3), any_hit=True,
                               label=f"spot occlusion {li}")
            falloff = falloff * (~occ_l.hit)
        fr_l = brdf_ops.evaluate(l_dir, view, nrm, base, rough, metal)
        color = color + fr_l * (lights.spot_color[li][None, :] * exposure) * falloff[:, None]
    for li in range(n_points):
        to_l = lights.point_pos[li][None, :] - world_pos
        dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
        dist = torch.sqrt(dist2)
        l_dir = to_l / dist
        vis_l = 1.0
        if li < len(point_casters) and point_casters[li]:
            occ_l = trace_rays(scene.bvh, occl_org, l_dir.contiguous(),
                               t_max=torch.clamp(dist[:, 0] - 6e-2, min=1e-3), any_hit=True,
                               label=f"point occlusion {li}")
            vis_l = (~occ_l.hit).to(torch.float32)[:, None]
        fr_l = brdf_ops.evaluate(l_dir, view, nrm, base, rough, metal)
        color = color + fr_l * (lights.point_color[li][None, :] * exposure) / dist2 * vis_l

    # The diffuse ambient the primary frame's LightingCompose adds.
    diffuse = base * (1.0 - metal) * ms.occlusion[:, None]
    if ddgi_sample is not None:
        ambient = ddgi_sample(world_pos, nrm)
    else:
        ambient = ambient_of_normal(scene.env_map, nrm, scene.env_brightness)
        ambient = (ambient + lights.ambient_lx / math.pi) * exposure
    color = color + diffuse * ambient

    env = sample_equirect(scene.env_map, ray_dirs) * scene.env_brightness * exposure
    return torch.where(hit_col, color, env)


def trace_shadow_mask(scene, world_pos: torch.Tensor, light_dir: torch.Tensor,
                      valid: torch.Tensor, label: str | None = None) -> torch.Tensor:
    """(N,) visibility of ``light_dir`` (toward the light) from receiver
    points by any-hit rays, biased 3 cm along the light direction and
    traced to 1e4; 1 where ``valid`` is False."""
    dirs = light_dir.expand_as(world_pos).contiguous()
    occl = trace_rays(scene.bvh, world_pos + dirs * 3e-2, dirs, t_max=1e4, any_hit=True,
                      label=label)
    return torch.where(valid, (~occl.hit).to(torch.float32), 1.0)
