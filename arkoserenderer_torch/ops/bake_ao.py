"""Ambient-occlusion baking over the scene's BVH, the
BakeAmbientOcclusionNode analogue (port of arkoserenderer_tpu/ops/bake_ao.py:
``bake_ao`` and ``bake_vertex_ao``).

From each surface point, one any-hit ray a direction of a Fibonacci sphere
(both hemispheres; the ones below the point's normal weigh nothing),
cosine-weighted: the unoccluded share is the AO, the weighted mean of the
free directions the bent normal. The rays go through ``ops/bvh.trace_rays``
(the traversal kernel on the card), every trace labelled "ao".
"""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.halton import fibonacci_sphere
from arkoserenderer_torch.ops.bvh import trace_rays


def bake_ao(bvh, points: torch.Tensor, normals: torch.Tensor, num_rays: int = 64,
            max_distance: float = 2.0, bias: float = 1e-2):
    """(N, 3) world points and unit normals -> (AO (N,) in [0, 1], 1
    unoccluded; bent normal (N, 3))."""
    dirs_all = torch.from_numpy(fibonacci_sphere(num_rays * 2).astype(np.float32)).to(
        points.device)
    n = points.shape[0]
    occl_sum = torch.zeros((n,), device=points.device)
    bent_sum = torch.zeros((n, 3), device=points.device)
    weight_sum = torch.zeros((n,), device=points.device)
    origins = (points + normals * bias).contiguous()
    for i in range(num_rays * 2):
        d = dirs_all[i]
        cos = mx.vdot(normals, d[None, :], keepdims=False)
        in_hemi = cos > 0.0
        hit = trace_rays(bvh, origins, d.expand(n, 3).contiguous(), t_max=max_distance,
                         any_hit=True, label="ao")
        w = torch.where(in_hemi, cos, 0.0)
        occl_sum = occl_sum + w * hit.hit.to(torch.float32)
        bent_sum = bent_sum + torch.where((in_hemi & ~hit.hit)[:, None], d[None, :] * w[:, None],
                                          0.0)
        weight_sum = weight_sum + w
    ao = 1.0 - occl_sum / torch.clamp(weight_sum, min=1e-6)
    bent = mx.normalize(bent_sum + normals * 1e-3)
    return ao, bent


def world_normals(scene_arrays) -> torch.Tensor:
    """The vertex pool's normals through each vertex's instance normal
    matrix, normalised: (V, 3) on the arrays' device."""
    inst = scene_arrays.vertex_instance.long()
    return mx.normalize(torch.einsum("vij,vj->vi", scene_arrays.normal_mat[inst],
                                     scene_arrays.normals))


def bake_vertex_ao(scene_arrays, num_rays: int = 64, max_distance: float = 2.0):
    """AO of every vertex of the pool, baked on the arrays' device (their
    BVH): numpy (V,) AO and (V, 3) bent normals."""
    from arkoserenderer_torch.models.pathtracer import world_space_vertices

    wp = torch.from_numpy(world_space_vertices(scene_arrays).astype(np.float32)).to(
        scene_arrays.positions.device)
    ao, bent = bake_ao(scene_arrays.bvh, wp, world_normals(scene_arrays), num_rays=num_rays,
                       max_distance=max_distance)
    return ao.cpu().numpy(), bent.cpu().numpy()
