"""Skinning and morph targets (port of arkoserenderer_tpu/ops/skinning.py).

Morph-target blend (weighted delta sums over a block of the vertex pool)
and 4-joint linear-blend skinning of positions, normals and tangents, as
eager torch ops. Both return new tensors and leave their inputs as they
were: the frame calls them on the scene's base pools every frame.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core.mathx import normalize


def skin_vertices(
    positions: torch.Tensor,     # (V, 3) bind-pose object space
    normals: torch.Tensor,       # (V, 3)
    tangents: torch.Tensor,      # (V, 4) xyz + handedness w
    skin_joints: torch.Tensor,   # (V, 4) i32 palette indices
    skin_weights: torch.Tensor,  # (V, 4) f32; an all-zero row is a static vertex
    palette: torch.Tensor,       # (J, 4, 4) joint world @ inverse bind
):
    """Returns (positions, normals, tangents) with the skinned rows
    replaced; directions go through the blended 3x3 (the usual LBS
    approximation) and are renormalised."""
    w = skin_weights
    is_skinned = torch.sum(w, dim=-1, keepdim=True) > 1e-6
    mats = palette[skin_joints.long()]                     # (V, 4, 4, 4)
    blend = torch.einsum("vk,vkab->vab", w, mats)          # (V, 4, 4)
    rot = blend[:, :3, :3]
    p_new = torch.einsum("vab,vb->va", rot, positions) + blend[:, :3, 3]
    n_new = normalize(torch.einsum("vab,vb->va", rot, normals))
    t_new = normalize(torch.einsum("vab,vb->va", rot, tangents[:, :3]))
    positions = torch.where(is_skinned, p_new, positions)
    normals = torch.where(is_skinned, n_new, normals)
    tangents = torch.cat([torch.where(is_skinned, t_new, tangents[:, :3]), tangents[:, 3:4]],
                         dim=-1)
    return positions, normals, tangents


def apply_morphs(
    positions: torch.Tensor,   # (V, 3)
    normals: torch.Tensor,     # (V, 3)
    morph_pos: torch.Tensor,   # (B, Vm, 3) position deltas of the block
    morph_nrm: torch.Tensor,   # (B, Vm, 3) normal deltas
    weights: torch.Tensor,     # (B,)
    vertex_offset: int,        # first vertex of the block in the pool
):
    """New (positions, normals) with the weighted deltas added to the block
    [vertex_offset, vertex_offset + Vm) and its normals renormalised."""
    vm = morph_pos.shape[1]
    end = vertex_offset + vm
    dp = torch.einsum("b,bvc->vc", weights, morph_pos)
    dn = torch.einsum("b,bvc->vc", weights, morph_nrm)
    positions = torch.cat([positions[:vertex_offset], positions[vertex_offset:end] + dp,
                           positions[end:]])
    normals = torch.cat([normals[:vertex_offset],
                         normalize(normals[vertex_offset:end] + dn), normals[end:]])
    return positions, normals
