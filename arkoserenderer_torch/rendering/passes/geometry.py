"""Geometry pass: vertices -> visibility buffer (port of
arkoserenderer_tpu/rendering/passes/geometry.py).

Instance frustum + LOD culling, per-meshlet sphere and cone culling when the
scene has meshlets, triangle setup with near clipping, binning,
the stage-4 tile raster (the CUDA kernel on the card; under pixel-band
sharding, of this rank's band at its ``y_offset``) and, under the packed
shading mode, the per-triangle shading records. The packed mode projects
the world-space pool (geom.vtx_world); the reference mode transforms the
object-space pool by the instance matrices. Translucent triangles are left
to the ForwardTranslucent pass.

Publishes:
  SceneDepth    (H, W) f32 reverse-Z
  Visibility    (H, W) i32 setup-row id (VIS_NONE background)
  vis.setup     TriSetup
  vis.records   (T', rec_size) f32 shading records (packed mode only)
  vis.overflow  () i32 bin entries dropped

Counts (the frame record, ``FrameContext.count``): geometry.triangles,
geometry.kept, raster.camera_dropped and raster.camera_binned.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.types import DEPTH_FAR, VIS_NONE
from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.ops.packed_shading import build_records, record_layout_for
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry
from arkoserenderer_torch.scene.scene import BLEND_TRANSLUCENT


def lod_instance_mask(scene, cam_pos: torch.Tensor) -> torch.Tensor:
    """(Dmax,) bool: drawables whose LOD band holds the camera distance."""
    d = torch.linalg.norm(scene.inst_sphere[:, :3] - cam_pos[None, :], dim=-1)
    band = scene.inst_lod_band
    return (d >= band[:, 0]) & (d < band[:, 1])


def transform_vertices_clip(scene, view_proj: torch.Tensor,
                            positions: torch.Tensor) -> torch.Tensor:
    """Object-space vertex pool -> (V, 4) clip space: ``view_proj`` folded
    into each instance matrix, gathered per vertex, applied elementwise."""
    mvp = torch.matmul(view_proj[None], scene.world)       # (D, 4, 4)
    m = mvp[scene.vertex_instance.long()]                  # (V, 4, 4)
    p = positions
    return torch.stack(
        [m[:, r, 0] * p[:, 0] + m[:, r, 1] * p[:, 1] + m[:, r, 2] * p[:, 2] + m[:, r, 3]
         for r in range(4)], dim=-1)


def translucent_triangles(scene) -> torch.Tensor:
    """(Tmax,) bool: triangles whose instance's material blends
    (BLEND_TRANSLUCENT)."""
    mat_of_tri = scene.inst_material[scene.tri_instance.long()].long()
    return scene.materials.blend_mode[mat_of_tri] == BLEND_TRANSLUCENT


def world_to_clip(view_proj: torch.Tensor, wpos: torch.Tensor) -> torch.Tensor:
    """(4,4) @ (V,3) world positions -> (V,4) clip, elementwise."""
    return torch.stack(mx.transform_point_lanes(view_proj, wpos), dim=-1)


def visible_triangles(scene, view_proj: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """(Tmax,) bool: valid triangles of instances inside the frustum of
    ``view_proj`` and inside their LOD band for the main camera."""
    planes = mx.frustum_planes_from_matrix(view_proj)
    inst_visible = mx.frustum_test_spheres(
        planes, scene.inst_sphere[:, :3], scene.inst_sphere[:, 3]
    ) & scene.inst_valid & lod_instance_mask(scene, cam_pos)
    return scene.tri_valid & inst_visible[scene.tri_instance.long()]


def meshlet_visible(scene, planes: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """(Mm,) bool: meshlets whose world-space bounding sphere meets the
    frustum ``planes`` and whose normal cone does not face wholly away from
    the camera (conservative: the cone test keeps the sphere's slack)."""
    w_m = scene.world[scene.meshlet_instance.long()]
    rot = w_m[:, :3, :3]
    c_w = torch.einsum("mij,mj->mi", rot, scene.meshlet_sphere[:, :3]) + w_m[:, :3, 3]
    scale = torch.linalg.norm(rot, dim=1).amax(dim=-1)
    r_w = scene.meshlet_sphere[:, 3] * scale
    visible = mx.frustum_test_spheres(planes, c_w, r_w)
    axis_w = mx.normalize(torch.einsum("mij,mj->mi", rot, scene.meshlet_cone[:, :3]))
    cutoff = scene.meshlet_cone[:, 3]
    to_cam = cam_pos[None, :] - c_w
    dist = torch.clamp(torch.linalg.norm(to_cam, dim=-1), min=1e-6)
    cos_view = torch.sum(axis_w * to_cam, dim=-1) / dist
    cone_ok = (cutoff < 0.1) | (
        cos_view > -torch.sqrt(torch.clamp(1.0 - cutoff * cutoff, min=0.0)) - r_w / dist)
    return visible & cone_ok & scene.meshlet_valid


def camera_visible_triangles(scene, view_proj: torch.Tensor, cam_pos: torch.Tensor,
                             has_meshlets: bool):
    """The Geometry pass's culling: (Tmax,) bool triangles after instance
    frustum and LOD culling, and after meshlet culling when the scene has
    meshlets; and the (Mm,) bool meshlets kept (None without meshlets)."""
    tri_visible = visible_triangles(scene, view_proj, cam_pos)
    if not has_meshlets:
        return tri_visible, None
    kept = meshlet_visible(scene, mx.frustum_planes_from_matrix(view_proj), cam_pos)
    return tri_visible & kept[scene.tri_meshlet.long()], kept


def count_bins(ctx: FrameContext, raster_name: str, bins: raster.TileBins) -> None:
    """The frame record's counters of one raster's binning: the entries the
    caps dropped, and those kept (tile-list entries and global triangles)."""
    ctx.count(f"raster.{raster_name}_dropped", bins.overflow)
    ctx.count(f"raster.{raster_name}_binned", bins.counts.sum() + bins.global_count)


class GeometryPass(RenderPass):
    name = "Geometry"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        packed = cfg.shading_mode == "packed"
        reg.get("geom.positions")
        if packed:
            reg.get("geom.vtx_world")
            reg.publish("vis.records")
        reg.create("SceneDepth", (cfg.height, cfg.width), torch.float32, clear=DEPTH_FAR)
        reg.create("Visibility", (cfg.height, cfg.width), torch.int32, clear=VIS_NONE)
        reg.publish("vis.setup")
        w, h, rcfg = cfg.width, cfg.height, cfg.raster
        full_h = cfg.frame_height
        layout = record_layout_for(cfg.scene)
        has_meshlets = cfg.scene.has_meshlets
        has_translucent = cfg.scene.has_translucent

        def execute(state: dict, ctx: FrameContext) -> dict:
            s, cam = ctx.scene, ctx.camera
            view_proj = cam.view_proj
            if packed:
                clip = world_to_clip(view_proj, state["geom.vtx_world"][:, 0:3])
            else:
                clip = transform_vertices_clip(s, view_proj, state["geom.positions"])
            tri_visible, _ = camera_visible_triangles(s, view_proj, cam.position, has_meshlets)
            if has_translucent:
                tri_visible = tri_visible & ~translucent_triangles(s)
            ctx.count("geometry.triangles", s.tri_valid.sum())
            ctx.count("geometry.kept", tri_visible.sum())
            # The screen mapping is the whole frame's; binning and the raster
            # cover this rank's band (h rows from ctx.row_offset).
            setup = raster.setup_triangles(clip, s.indices, tri_visible, w, full_h,
                                           w_eps=cam.near)
            bins = raster.bin_triangles(setup, w, h, rcfg, y_offset=ctx.row_offset)
            count_bins(ctx, "camera", bins)
            vis, depth = raster.rasterize_tiles(setup, bins, w, h, rcfg,
                                                y_offset=ctx.row_offset)
            out = {
                "SceneDepth": depth,
                "Visibility": vis,
                "vis.setup": setup,
                "vis.overflow": bins.overflow,
            }
            if packed:
                out["vis.records"] = build_records(
                    setup, state["geom.vtx_world"], s.indices, s.tri_material,
                    s.mat_records, layout=layout)
            return out

        return execute
