"""Packed-record deferred shading (port of
arkoserenderer_tpu/ops/packed_shading.py, the raster frames' subset).

Everything a pixel needs is folded into one per-triangle record at
geometry time, so shading does one record gather per pixel, the texel taps
(ops/mattex), one sun shadow tap (ops/shadow VSM) and, per shadow-casting
spot light, one PCF disc.

``shade_packed`` sends CUDA tensors to the hand-written kernel
(csrc/packed_shading.cu, wrapped by ops/packed_shading_cuda.py), which does
all of it in one launch, and CPU tensors to ``shade_packed_plain``, the
plain torch version that the tests and chip_smoke.py hold the kernel
against.

Record layout (``rec_size`` f32 lanes per raster setup row, permuted per
scene by ``RecLayout``):
  [0:6)   screen xy of the 3 corners
  [6:9)   1/w_clip per corner
  then    3 corners x c_stride lanes: wpos(3) [prev_wpos(3)] wnrm(3)
          [wtan(3) tanw(1)] uv(2), already folded through corner_bary
  then    the material record (MREC_SIZE lanes), then pad to a multiple of 8

Material record: [0:4) base_color_factor [4:7) emissive_factor [7] metallic
[8] roughness [9] double_sided [10] clearcoat [11] clearcoat_roughness
[12] subsurface [13] alpha_cutoff [14] blend_mode [15:32) packed-texture
meta (ops/mattex.META_LANES).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.ops import brdf, mattex
from arkoserenderer_torch.ops.noise import sample_blue_noise
from arkoserenderer_torch.ops.raster import TriSetup
from arkoserenderer_torch.ops.shading import GBuffer
from arkoserenderer_torch.ops.shadow import sample_shadow_pcf, sample_vsm

MREC_SIZE = 32

M_BASEF, M_EMIF, M_METAL, M_ROUGH = 0, 4, 7, 8
M_DSIDED, M_CC, M_CCR, M_SSS = 9, 10, 11, 12
M_TEXMETA = 15


class RecLayout(NamedTuple):
    """Record layout permutation: static scenes drop the prev-position
    lanes, scenes without normal maps the tangent lanes."""

    has_prev: bool
    has_tan: bool
    c_stride: int
    rec_size: int
    o_prev: int
    o_nrm: int
    o_tan: int
    o_uv: int


def record_layout_for(scene_static) -> RecLayout:
    """Layout from SceneStatic flags (one source for all passes)."""
    any_tex = (
        scene_static.uses_base_tex or scene_static.uses_normal_tex
        or scene_static.uses_mr_tex or scene_static.uses_emissive_tex
        or scene_static.uses_occlusion_tex
    )
    return record_layout(scene_static, any_tex)


def record_layout(scene_static, any_tex: bool) -> RecLayout:
    """Layout for a scene: prev-position lanes only when geometry moves,
    tangent lanes only when a material samples a normal map."""
    has_prev = bool(
        scene_static.dynamic or scene_static.has_skin
        or scene_static.has_morphs or scene_static.has_hair
    )
    return layout_of(has_prev, bool(any_tex and scene_static.uses_normal_tex))


def layout_of(has_prev: bool, has_tan: bool) -> RecLayout:
    """The record layout with (or without) the prev-position and tangent
    lanes."""
    o = 3                                   # wpos
    o_prev = o if has_prev else -1
    o += 3 if has_prev else 0
    o_nrm = o
    o += 3
    o_tan = o if has_tan else -1
    o += 4 if has_tan else 0
    o_uv = o
    o += 2
    c_stride = o
    base = 9 + 3 * c_stride + MREC_SIZE
    rec_size = (base + 7) // 8 * 8
    return RecLayout(has_prev, has_tan, c_stride, rec_size, o_prev, o_nrm, o_tan, o_uv)


def build_vertex_world(scene, positions, normals, tangents,
                       layout: RecLayout) -> torch.Tensor:
    """Per-vertex world-space pool (V, c_stride):
    [wpos3, (prev_wpos3), wnrm3, (wtan3, tanw), uv2] per ``layout``."""
    d = scene.world.shape[0]
    parts_m = [scene.world[:, :3, :].reshape(d, 12)]
    if layout.has_prev:
        parts_m.append(scene.prev_world[:, :3, :].reshape(d, 12))
    parts_m.append(scene.normal_mat.reshape(d, 9))
    m = torch.cat(parts_m, dim=-1)[scene.vertex_instance.long()]
    w_rot = m[:, 0:12].reshape(-1, 3, 4)
    off = 12
    if layout.has_prev:
        p_rot = m[:, off:off + 12].reshape(-1, 3, 4)
        off += 12
    n_rot = m[:, off:off + 9].reshape(-1, 3, 3)

    wpos = mx.apply_rows(w_rot, positions)
    parts = [wpos]
    if layout.has_prev:
        parts.append(mx.apply_rows(p_rot, positions))
    parts.append(mx.normalize(mx.apply_rows(n_rot, normals, translate=False)))
    if layout.has_tan:
        parts.append(mx.normalize(mx.apply_rows(w_rot, tangents[:, :3], translate=False)))
        parts.append(tangents[:, 3:4])
    parts.append(scene.uvs)
    return torch.cat(parts, dim=-1)


def build_records(
    setup: TriSetup,
    vtx_world: torch.Tensor,    # (V, c_stride)
    indices: torch.Tensor,      # (Tmax, 3) i32
    tri_material: torch.Tensor,  # (Tmax,) i32
    mat_records: torch.Tensor,  # (M, 32)
    layout: RecLayout,
) -> torch.Tensor:
    """(T', rec_size) shading records, one per raster setup row; the
    corners are the clipped sub-triangle's (corner_bary folded in)."""
    cs = vtx_world.shape[-1]
    t = setup.orig_tri.shape[0]
    orig = setup.orig_tri.long()
    vtx = vtx_world[indices[orig].long()]        # (T', 3, cs)
    cb = setup.corner_bary                       # (T', 3, 3)
    sub = (
        cb[:, :, 0:1] * vtx[:, None, 0, :]
        + cb[:, :, 1:2] * vtx[:, None, 1, :]
        + cb[:, :, 2:3] * vtx[:, None, 2, :]
    )
    mrec = mat_records[tri_material[orig].long()]
    base = 9 + 3 * cs + MREC_SIZE
    return torch.cat(
        [
            setup.screen_xy.reshape(t, 6),
            setup.inv_w,
            sub.reshape(t, 3 * cs),
            mrec,
            vtx_world.new_zeros((t, layout.rec_size - base)),
        ],
        dim=-1,
    )


def shade_packed(scene, cam, vis_flat: torch.Tensor, *args, **kwargs) -> GBuffer:
    """Deferred shading of the visibility buffer (``shade_packed_plain``'s
    arguments and contract): CUDA tensors go to the hand-written kernel
    (``ops.packed_shading_cuda.shade_packed_cuda``, which raises on what it
    does not take), CPU tensors to ``shade_packed_plain``; any other device
    raises."""
    dev = vis_flat.device
    if dev.type == "cuda":
        from arkoserenderer_torch.ops.packed_shading_cuda import shade_packed_cuda

        return shade_packed_cuda(scene, cam, vis_flat, *args, **kwargs)
    if dev.type == "cpu":
        return shade_packed_plain(scene, cam, vis_flat, *args, **kwargs)
    raise NotImplementedError(f"shade_packed has no path for device {dev}")


def shade_packed_plain(
    scene,
    cam,
    vis_flat: torch.Tensor,     # (N,) setup-row ids (VIS_NONE background)
    depth_flat: torch.Tensor,   # (N,)
    records: torch.Tensor,      # (T', rec_size)
    px: torch.Tensor,
    py: torch.Tensor,
    width: int,
    height: int,
    shadow_moments: torch.Tensor | None = None,  # (S, S, 2) sun VSM
    sun_shadow_vp: torch.Tensor | None = None,
    shadow_mask: torch.Tensor | None = None,        # (N,) RT sun visibility: wins
    local_shadow_maps: torch.Tensor | None = None,  # (n_spots, A, A) depth
    spot_shadow_flags: tuple | None = None,         # per spot: samples its map
    rt_spot_masks: torch.Tensor | None = None,      # (S, N) RT spot visibility: wins
    rt_point_masks: torch.Tensor | None = None,     # (P, N) RT point visibility
    n_spots: int = 0,
    n_points: int = 0,
    any_tex: bool = True,
    mip_bias: float = 0.0,
    texture_quality: str = "trilinear",  # ops.mattex.sample_packed's quality
    shadow_filter: str = "bilinear",     # | "stochastic" (one jittered VSM tap)
    frame_index: int = 0,                # the stochastic filters' blue-noise frame
    *,
    layout: RecLayout,
) -> GBuffer:
    """Deferred shading of the visibility buffer: the sun (VSM-shadowed, or
    by the ray-traced ``shadow_mask``), the first ``n_spots`` spot lights
    (cone, IES profile; shadowed by ``rt_spot_masks``, else PCF where
    flagged) and ``n_points`` point lights (by ``rt_point_masks`` when
    given) through the Filament BRDF, emissive, and the velocity G-buffer.
    ``mip_bias`` biases the texture LOD (the upscaler's drive);
    ``texture_quality`` is ``ops.mattex.sample_packed``'s ``quality`` and
    ``shadow_filter`` ``ops.shadow.sample_vsm``'s ``taps``. The stochastic
    filters draw per-pixel blue noise of ``frame_index``: salt 0 picks the
    mip ("stochastic"), salts 0, 3 and 4 the mip and the texel
    ("stochastic1"), salts 1 and 2 the VSM texel."""
    cs = layout.c_stride
    valid = vis_flat >= 0
    rec = records[torch.clamp(vis_flat, min=0).long()]   # the per-pixel gather
    n = px.shape[0]
    exposure = cam.exposure

    ax, ay = rec[:, 0], rec[:, 1]
    bx, by = rec[:, 2], rec[:, 3]
    cx, cy = rec[:, 4], rec[:, 5]
    iw0, iw1, iw2 = rec[:, 6], rec[:, 7], rec[:, 8]

    def edge(px_, py_, ox, oy, ex_, ey_):
        return (ey_ - oy) * (px_ - ox) - (ex_ - ox) * (py_ - oy)

    e0 = edge(px, py, bx, by, cx, cy)
    e1 = edge(px, py, cx, cy, ax, ay)
    e2 = edge(px, py, ax, ay, bx, by)
    # Edge functions are affine in (px, py): the +1 px deltas are
    # per-triangle constants.
    d0x, d0y = cy - by, -(cx - bx)
    d1x, d1y = ay - cy, -(ax - cx)
    d2x, d2y = by - ay, -(bx - ax)

    def bary_of(f0, f1, f2):
        p0, p1, p2 = f0 * iw0, f1 * iw1, f2 * iw2
        den = p0 + p1 + p2
        inv = torch.where(torch.abs(den) > 1e-20, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
        return p0 * inv, p1 * inv, p2 * inv

    b0, b1, b2 = bary_of(e0, e1, e2)
    bx0, bx1, bx2 = bary_of(e0 + d0x, e1 + d1x, e2 + d2x)
    by0, by1, by2 = bary_of(e0 + d0y, e1 + d1y, e2 + d2y)

    def lane(j):  # interpolated attribute lane j
        return b0 * rec[:, 9 + j] + b1 * rec[:, 9 + cs + j] + b2 * rec[:, 9 + 2 * cs + j]

    def lanes3(j):
        return torch.stack([lane(j), lane(j + 1), lane(j + 2)], dim=-1)

    mo = 9 + 3 * cs
    mrec = rec[:, mo:mo + MREC_SIZE]

    world_pos = lanes3(0)
    prev_world_pos = lanes3(layout.o_prev) if layout.has_prev else world_pos
    world_nrm = mx.normalize(lanes3(layout.o_nrm))
    if layout.has_tan:
        world_tan = mx.normalize(lanes3(layout.o_tan))
        tanw = lane(layout.o_tan + 3)[:, None]
    ju = layout.o_uv
    u_c0, u_c1, u_c2 = rec[:, 9 + ju], rec[:, 9 + cs + ju], rec[:, 9 + 2 * cs + ju]
    v_c0, v_c1, v_c2 = rec[:, 10 + ju], rec[:, 10 + cs + ju], rec[:, 10 + 2 * cs + ju]
    uv = torch.stack([b0 * u_c0 + b1 * u_c1 + b2 * u_c2,
                      b0 * v_c0 + b1 * v_c1 + b2 * v_c2], dim=-1)
    duv_dx = torch.stack(
        [(bx0 - b0) * u_c0 + (bx1 - b1) * u_c1 + (bx2 - b2) * u_c2,
         (bx0 - b0) * v_c0 + (bx1 - b1) * v_c1 + (bx2 - b2) * v_c2], dim=-1)
    duv_dy = torch.stack(
        [(by0 - b0) * u_c0 + (by1 - b1) * u_c1 + (by2 - b2) * u_c2,
         (by0 - b0) * v_c0 + (by1 - b1) * v_c1 + (by2 - b2) * v_c2], dim=-1)

    base_factor = mrec[:, M_BASEF:M_BASEF + 4]
    emissive_factor = mrec[:, M_EMIF:M_EMIF + 3]
    metallic_f = mrec[:, M_METAL:M_METAL + 1]
    roughness_f = mrec[:, M_ROUGH:M_ROUGH + 1]
    double_sided = mrec[:, M_DSIDED] > 0.5
    clearcoat = mrec[:, M_CC:M_CC + 1]
    cc_rough = mrec[:, M_CCR:M_CCR + 1]
    subsurface = mrec[:, M_SSS]

    def pixel_noise(salt: int) -> torch.Tensor:
        return sample_blue_noise(px, py, frame_index, salt)

    if any_tex:
        if texture_quality == "stochastic1":
            noise = torch.stack([pixel_noise(0), pixel_noise(3), pixel_noise(4)], dim=-1)
        elif texture_quality == "stochastic":
            noise = pixel_noise(0)
        else:
            noise = None
        ms = mattex.sample_packed(
            scene.mat_tex.rows, mrec[:, M_TEXMETA:M_TEXMETA + mattex.META_LANES],
            uv, duv_dx, duv_dy, lod_bias=mip_bias, quality=texture_quality, noise=noise,
        )
        base_color = ms.base[:, :3] * base_factor[:, :3]
        roughness = torch.clamp(ms.rough_metal[:, 0:1] * roughness_f, 0.0, 1.0)
        metallic = torch.clamp(ms.rough_metal[:, 1:2] * metallic_f, 0.0, 1.0)
        emissive = ms.emissive * emissive_factor
        occlusion = ms.occlusion[:, None]
        if layout.has_tan:
            n_ts = ms.normal_ts
            bitan = torch.cross(world_nrm, world_tan, dim=-1) * tanw
            shading_nrm = mx.normalize(
                n_ts[:, 0:1] * world_tan + n_ts[:, 1:2] * bitan + n_ts[:, 2:3] * world_nrm
            )
        else:
            shading_nrm = world_nrm
    else:
        base_color = base_factor[:, :3]
        roughness = torch.clamp(roughness_f, 0.0, 1.0)
        metallic = torch.clamp(metallic_f, 0.0, 1.0)
        emissive = emissive_factor
        occlusion = torch.ones_like(roughness)
        shading_nrm = world_nrm

    view = mx.normalize(cam.position[None, :] - world_pos)
    facing = torch.sign(mx.vdot(shading_nrm, view))
    flip = torch.where(double_sided[:, None], facing, 1.0)
    shading_nrm = shading_nrm * torch.where(flip == 0.0, 1.0, flip)

    color = emissive * exposure
    sun_l = -scene.lights.sun_direction[None, :]
    if shadow_mask is not None:
        shadow = shadow_mask
    elif shadow_moments is not None:
        n_dot_l_geo = torch.clamp(mx.vdot(world_nrm, sun_l, keepdims=False), 0.0, 1.0)
        noise2 = (torch.stack([pixel_noise(1), pixel_noise(2)], dim=-1)
                  if shadow_filter == "stochastic" else None)
        shadow = sample_vsm(shadow_moments, sun_shadow_vp, world_pos, n_dot_l_geo,
                            taps=shadow_filter, noise2=noise2)
    else:
        shadow = torch.ones((n,), dtype=color.dtype, device=color.device)
    sun_fr = brdf.evaluate(
        sun_l.expand(n, 3), view, shading_nrm,
        base_color, roughness, metallic, clearcoat, cc_rough,
    )
    sun_radiance = scene.lights.sun_color[None, :] * exposure
    color = color + sun_fr * sun_radiance * shadow[:, None] * scene.lights.sun_valid

    lights = scene.lights
    for i in range(n_spots):
        to_l = lights.spot_pos[i][None, :] - world_pos
        dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
        l = to_l * torch.rsqrt(dist2)
        cos_dir = -mx.vdot(l, lights.spot_dir[i][None, :], keepdims=False)
        cone = lights.spot_cone[i]  # cos(inner), cos(outer)
        t = torch.clamp((cos_dir - cone[1]) / torch.clamp(cone[0] - cone[1], min=1e-4), 0.0, 1.0)
        angle_idx = torch.clamp(
            (torch.acos(torch.clamp(cos_dir, -1.0, 1.0)) / math.pi * 255.0).to(torch.int64),
            0, 255)
        falloff = t * t * lights.spot_ies[i][angle_idx] / dist2[:, 0]
        if rt_spot_masks is not None:
            falloff = falloff * rt_spot_masks[i]
        elif (local_shadow_maps is not None and spot_shadow_flags is not None
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
        vis_p = rt_point_masks[i][:, None] if rt_point_masks is not None else 1.0
        color = color + fr * (lights.point_color[i][None, :] * exposure) / dist2 * vis_p

    def to_screen(vp, p):
        sx_, sy_, w_c = mx.transform_point_lanes(vp, p, rows=(0, 1, 3))
        inv = torch.where(torch.abs(w_c) > 1e-8, 1.0 / torch.where(w_c == 0, 1.0, w_c), 0.0)
        return torch.stack([(sx_ * inv * 0.5 + 0.5) * width,
                            (0.5 - sy_ * inv * 0.5) * height], dim=-1)

    velocity = to_screen(cam.unjittered_view_proj, world_pos) - to_screen(
        cam.prev_view_proj, prev_world_pos)

    vf = valid[:, None]
    return GBuffer(
        color=torch.where(vf, color, 0.0),
        normal=torch.where(vf, shading_nrm, 0.0),
        velocity=torch.where(vf, velocity, 0.0),
        base_color=torch.where(vf, base_color, 0.0),
        material=torch.where(
            vf, torch.cat([roughness, metallic, occlusion, subsurface[:, None]], dim=-1), 0.0
        ),
        depth=depth_flat,
        valid=valid,
    )
