"""Geometry pass: world-space vertices -> visibility buffer (port of
arkoserenderer_tpu/rendering/passes/geometry.py, packed branch without
meshlets or translucency).

Instance frustum + LOD culling, triangle setup with near clipping, binning,
the stage-4 tile raster (the CUDA kernel on the card) and the per-triangle
shading records.

Publishes:
  SceneDepth    (H, W) f32 reverse-Z
  Visibility    (H, W) i32 setup-row id (VIS_NONE background)
  vis.setup     TriSetup
  vis.records   (T', rec_size) f32 shading records
  vis.overflow  () i32 bin entries dropped
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.types import DEPTH_FAR, VIS_NONE
from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.ops.packed_shading import build_records, record_layout_for
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry


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


class GeometryPass(RenderPass):
    name = "Geometry"

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        if cfg.scene.has_meshlets or cfg.scene.has_translucent:
            raise NotImplementedError("meshlet culling and translucency are not ported yet")
        reg.get("geom.positions")
        reg.get("geom.vtx_world")
        reg.publish("vis.records")
        reg.create("SceneDepth", (cfg.height, cfg.width), torch.float32, clear=DEPTH_FAR)
        reg.create("Visibility", (cfg.height, cfg.width), torch.int32, clear=VIS_NONE)
        reg.publish("vis.setup")
        w, h, rcfg = cfg.width, cfg.height, cfg.raster
        layout = record_layout_for(cfg.scene)

        def execute(state: dict, ctx: FrameContext) -> dict:
            s, cam = ctx.scene, ctx.camera
            view_proj = cam.view_proj
            clip = world_to_clip(view_proj, state["geom.vtx_world"][:, 0:3])
            setup = raster.setup_triangles(
                clip, s.indices, visible_triangles(s, view_proj, cam.position), w, h,
                w_eps=cam.near,
            )
            bins = raster.bin_triangles(setup, w, h, rcfg)
            vis, depth = raster.rasterize_tiles(setup, bins, w, h, rcfg)
            return {
                "SceneDepth": depth,
                "Visibility": vis,
                "vis.setup": setup,
                "vis.overflow": bins.overflow,
                "vis.records": build_records(
                    setup, state["geom.vtx_world"], s.indices, s.tri_material,
                    s.mat_records, layout=layout,
                ),
            }

        return execute
