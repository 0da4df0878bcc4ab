"""Per-field deferred shading of the visibility buffer, the G-buffer type
and the sky fill (port of arkoserenderer_tpu/ops/shading.py).

``shade_visibility_buffer`` is the reference shading mode's path
(``shading_mode="reference"``) and the translucent pass's shader: per
pixel it rebuilds the original triangle and its barycentrics from the
raster's setup row (``ops/interpolate``), gathers the instance's matrices
and the material's fields, interpolates the vertex attributes, samples the
RGBA8 texture pool with gradient-correct LOD (``ops/texture.sample_grad``)
and evaluates the Filament BRDF for the sun (PCF map or ray-traced mask),
the spot lights (cone, IES profile, optional shadow map) and the point
lights. Every pixel of the screen is shaded, covered or not; the uncovered
ones are masked at the end. The packed path (``ops/packed_shading``) folds
the same work into one record gather per pixel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.ops import brdf
from arkoserenderer_torch.ops import interpolate as ip
from arkoserenderer_torch.ops import texture as tx
from arkoserenderer_torch.ops.envmap import sample_equirect
from arkoserenderer_torch.ops.raster import TriSetup
from arkoserenderer_torch.ops.shadow import sample_shadow_pcf


class GBuffer(NamedTuple):
    """Flattened (N, ...) G-buffer."""

    color: torch.Tensor       # (N, 3) pre-exposed linear HDR
    normal: torch.Tensor      # (N, 3) world-space shading normal
    velocity: torch.Tensor    # (N, 2) screen-space motion in pixels (cur - prev)
    base_color: torch.Tensor  # (N, 3)
    material: torch.Tensor    # (N, 4) roughness, metallic, occlusion, subsurface
    depth: torch.Tensor       # (N,) raster depth (reverse-Z)
    valid: torch.Tensor       # (N,) bool geometry coverage


def shade_visibility_buffer(
    scene,
    cam,
    vis_flat: torch.Tensor,     # (N,) setup-row ids (VIS_NONE background)
    depth_flat: torch.Tensor,   # (N,)
    setup: TriSetup,
    px: torch.Tensor,           # (N,) pixel centres
    py: torch.Tensor,
    width: int,
    height: int,
    shadow_map: torch.Tensor | None = None,         # (S, S) sun shadow depth
    sun_shadow_vp: torch.Tensor | None = None,
    shadow_mask: torch.Tensor | None = None,        # (N,) RT sun visibility: wins over the map
    local_shadow_maps: torch.Tensor | None = None,  # (n_spots, A, A) depth
    spot_shadow_flags: tuple | None = None,         # per spot: samples its map
    positions: torch.Tensor | None = None,          # animated object-space pools
    normals: torch.Tensor | None = None,            # (default: the scene's)
    tangents: torch.Tensor | None = None,
    n_spots: int | None = None,                     # light counts (loops unroll)
    n_points: int | None = None,
    tex_flags=None,                                 # SceneStatic texture-usage flags
    texture_quality: str = "trilinear",             # ops.texture.sample_grad's quality
) -> GBuffer:
    """The G-buffer of the visibility buffer, shaded field by field (see
    the module docstring). The texture slots no material uses
    (``tex_flags``) are not sampled. Light counts default to the scene's
    light arrays."""
    positions = scene.positions if positions is None else positions
    normals = scene.normals if normals is None else normals
    tangents = scene.tangents if tangents is None else tangents
    lights = scene.lights
    if n_spots is None:
        n_spots = lights.spot_pos.shape[0]
    if n_points is None:
        n_points = lights.point_pos.shape[0]

    geom = ip.pixel_barycentrics(vis_flat, setup, scene.indices, px, py)
    n = px.shape[0]
    exposure = cam.exposure
    inst = scene.tri_instance[geom.tri].long()      # (N,)
    mat_id = scene.inst_material[inst].long()       # (N,)
    m = scene.materials

    # -- geometry ------------------------------------------------------------
    obj_pos = ip.interpolate(positions, geom)
    w_rows = scene.world[inst, :3, :]               # (N, 3, 4)
    world_pos = mx.apply_rows(w_rows, obj_pos, translate=True)
    prev_world_pos = mx.apply_rows(scene.prev_world[inst, :3, :], obj_pos, translate=True)
    world_nrm = mx.normalize(mx.apply_rows(scene.normal_mat[inst], ip.interpolate(normals, geom),
                                   translate=False))
    obj_tan = ip.interpolate(tangents, geom)
    world_tan = mx.normalize(mx.apply_rows(w_rows, obj_tan[:, :3], translate=False))
    del w_rows
    uv, duv_dx, duv_dy = ip.interpolate_with_grad(scene.uvs, geom)

    # -- material textures ---------------------------------------------------
    def use(flag, default=True):
        return default if tex_flags is None else getattr(tex_flags, flag)

    pow2 = bool(getattr(tex_flags, "textures_pow2", False))

    def sample(tex, srgb=True):
        return tx.sample_grad(scene.textures, tex[mat_id], uv, duv_dx, duv_dy,
                              decode_srgb=srgb, quality=texture_quality, pow2=pow2)

    if use("uses_base_tex"):
        base_color = sample(m.base_color_tex)[:, :3] * m.base_color_factor[mat_id][:, :3]
    else:
        base_color = m.base_color_factor[mat_id][:, :3]
    if use("uses_mr_tex"):
        mr = sample(m.mr_tex, srgb=False)
        roughness = torch.clamp(mr[:, 1:2] * m.roughness_factor[mat_id][:, None], 0.0, 1.0)
        metallic = torch.clamp(mr[:, 2:3] * m.metallic_factor[mat_id][:, None], 0.0, 1.0)
    else:
        roughness = torch.clamp(m.roughness_factor[mat_id][:, None], 0.0, 1.0)
        metallic = torch.clamp(m.metallic_factor[mat_id][:, None], 0.0, 1.0)
    if use("uses_emissive_tex", False):
        emissive = sample(m.emissive_tex)[:, :3] * m.emissive_factor[mat_id]
    else:
        emissive = m.emissive_factor[mat_id]
    if use("uses_occlusion_tex", False):
        occlusion = sample(m.occlusion_tex, srgb=False)[:, 0:1]
    else:
        occlusion = torch.ones_like(roughness)

    # -- normal mapping (MikkT-style TBN) --------------------------------------
    if use("uses_normal_tex"):
        n_ts = sample(m.normal_tex, srgb=False)[:, :3] * 2.0 - 1.0
        bitan = torch.cross(world_nrm, world_tan, dim=-1) * obj_tan[:, 3:4]
        shading_nrm = mx.normalize(
            n_ts[:, 0:1] * world_tan + n_ts[:, 1:2] * bitan + n_ts[:, 2:3] * world_nrm)
    else:
        shading_nrm = world_nrm

    view = mx.normalize(cam.position[None, :] - world_pos)
    # Double-sided materials flip the normal toward the viewer.
    facing = torch.sign(mx.vdot(shading_nrm, view))
    flip = torch.where(m.double_sided[mat_id][:, None], facing, 1.0)
    shading_nrm = shading_nrm * torch.where(flip == 0.0, 1.0, flip)
    clearcoat = m.clearcoat[mat_id][:, None]
    cc_rough = m.clearcoat_roughness[mat_id][:, None]

    # -- direct lighting -------------------------------------------------------
    color = emissive * exposure
    sun_l = -lights.sun_direction[None, :]
    if shadow_mask is not None:
        shadow = shadow_mask
    elif shadow_map is not None:
        n_dot_l_geo = torch.clamp(mx.vdot(world_nrm, sun_l, keepdims=False), 0.0, 1.0)
        shadow = sample_shadow_pcf(shadow_map, sun_shadow_vp, world_pos, n_dot_l_geo)
    else:
        shadow = torch.ones((n,), dtype=color.dtype, device=color.device)
    sun_fr = brdf.evaluate(sun_l.expand(n, 3), view, shading_nrm, base_color, roughness,
                           metallic, clearcoat, cc_rough)
    color = color + sun_fr * (lights.sun_color[None, :] * exposure) * shadow[:, None] \
        * lights.sun_valid

    for i in range(n_spots):
        to_l = lights.spot_pos[i][None, :] - world_pos
        dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
        l = to_l * torch.rsqrt(dist2)
        cos_dir = -mx.vdot(l, lights.spot_dir[i][None, :], keepdims=False)
        cone = lights.spot_cone[i]  # cos(inner), cos(outer)
        t = torch.clamp((cos_dir - cone[1]) / torch.clamp(cone[0] - cone[1], min=1e-4), 0.0, 1.0)
        # IES profile: a 256-entry polar-angle LUT. The index comes from a
        # float: NaN lanes (uncovered pixels) are zeroed before the cast.
        angle = torch.acos(torch.clamp(cos_dir, -1.0, 1.0)) / math.pi * 255.0
        angle_idx = torch.clamp(torch.nan_to_num(angle, nan=0.0).to(torch.int64), 0, 255)
        falloff = t * t * lights.spot_ies[i][angle_idx] / dist2[:, 0]
        if (local_shadow_maps is not None and spot_shadow_flags is not None
                and i < len(spot_shadow_flags) and spot_shadow_flags[i]):
            n_dot_l_spot = torch.clamp(mx.vdot(world_nrm, l, keepdims=False), 0.0, 1.0)
            falloff = falloff * sample_shadow_pcf(
                local_shadow_maps[i], lights.spot_view_proj[i], world_pos, n_dot_l_spot)
        fr = brdf.evaluate(l, view, shading_nrm, base_color, roughness, metallic)
        color = color + fr * (lights.spot_color[i][None, :] * exposure) * falloff[:, None]

    for i in range(n_points):
        to_l = lights.point_pos[i][None, :] - world_pos
        dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
        l = to_l * torch.rsqrt(dist2)
        fr = brdf.evaluate(l, view, shading_nrm, base_color, roughness, metallic)
        color = color + fr * (lights.point_color[i][None, :] * exposure) / dist2

    # -- velocity: the unjittered projection minus the previous one, in pixels.
    def to_screen(vp, p):
        sx, sy, w_c = mx.transform_point_lanes(vp, p, rows=(0, 1, 3))
        inv_w = torch.where(torch.abs(w_c) > 1e-8, 1.0 / torch.where(w_c == 0, 1.0, w_c), 0.0)
        return torch.stack([(sx * inv_w * 0.5 + 0.5) * width,
                            (0.5 - sy * inv_w * 0.5) * height], dim=-1)

    velocity = to_screen(cam.unjittered_view_proj, world_pos) - to_screen(
        cam.prev_view_proj, prev_world_pos)

    valid = geom.valid
    vf = valid[:, None]
    return GBuffer(
        color=torch.where(vf, color, 0.0),
        normal=torch.where(vf, shading_nrm, 0.0),
        velocity=torch.where(vf, velocity, 0.0),
        base_color=torch.where(vf, base_color, 0.0),
        material=torch.where(
            vf, torch.cat([roughness, metallic, occlusion, m.subsurface[mat_id][:, None]],
                          dim=-1), 0.0),
        depth=depth_flat,
        valid=valid,
    )


def shade_sky(scene, cam, color, valid, px, py, width: int, height: int):
    """Fill uncovered pixels with the environment map along the camera ray
    and return (color, sky_velocity); the sky velocity reprojects the ray's
    far point through the previous view-projection."""
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = (0.5 - py / height) * 2.0
    # inv_ex: no singularity check, which would read back from the device.
    inv_vp = torch.linalg.inv_ex(cam.unjittered_view_proj).inverse
    d_h = torch.stack(
        [ndc_x, ndc_y, torch.full_like(ndc_x, 0.5), torch.ones_like(ndc_x)], dim=-1
    )
    world_h = d_h @ inv_vp.T
    den = world_h[:, 3:4]
    inv = torch.where(torch.abs(den) > 1e-10, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    dirs = mx.normalize(world_h[:, :3] * inv - cam.position[None, :])
    sky = sample_equirect(scene.env_map, dirs) * scene.env_brightness * cam.exposure

    far_point = cam.position[None, :] + dirs * 1e4
    prev_clip = mx.transform_points_h(cam.prev_view_proj, far_point)
    pw = prev_clip[:, 3]
    inv_pw = torch.where(torch.abs(pw) > 1e-8, 1.0 / torch.where(pw == 0, 1.0, pw), 0.0)
    prev_sx = (prev_clip[:, 0] * inv_pw * 0.5 + 0.5) * width
    prev_sy = (0.5 - prev_clip[:, 1] * inv_pw * 0.5) * height
    sky_vel = torch.stack([px - prev_sx, py - prev_sy], dim=-1)
    return torch.where(valid[:, None], color, sky), sky_vel
