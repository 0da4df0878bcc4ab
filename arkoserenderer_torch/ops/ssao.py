"""Screen-space ambient occlusion, hemisphere kernel (port of
arkoserenderer_tpu/ops/ssao.py, the dense branch: every kernel sample,
every frame).

N hemisphere samples oriented by the pixel normal are projected back into
the depth buffer; a sample is occluded when the scene surface lies in front
of it, weighted by a range check. The kernel is rotated per pixel by a hash
of the pixel centre; the pass blurs the result 3x3 to hide that noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.halton import halton_sequence_2d
from arkoserenderer_torch.ops.image import clamped_index


def make_ssao_kernel(n_samples: int = 16, seed_bias: float = 0.35) -> np.ndarray:
    """(n, 3) tangent-space hemisphere samples, biased toward the centre."""
    h = halton_sequence_2d(n_samples, (2, 3))
    phi = 2.0 * np.pi * h[:, 0]
    cos_t = np.sqrt(1.0 - h[:, 1])  # cosine-weighted
    sin_t = np.sqrt(h[:, 1])
    d = np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t, cos_t], -1)
    # Scale samples inward so near-field occlusion dominates.
    scale = seed_bias + (1.0 - seed_bias) * (np.arange(n_samples) / n_samples) ** 2
    return (d * scale[:, None]).astype(np.float32)


def inverse4(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a (4, 4) matrix on its device, without the singularity
    check that would read the device back."""
    return torch.linalg.inv_ex(m).inverse


def reconstruct_world_pos(depth_flat, px, py, inv_view_proj, width: int, height: int):
    """Reverse-Z depth + pixel centres -> (N, 3) world positions. Sky pixels
    (depth 0 under an infinite-far projection) would divide by w = 0; the
    guarded division gives them position 0 instead."""
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = (0.5 - py / height) * 2.0
    h = torch.stack([ndc_x, ndc_y, depth_flat, torch.ones_like(ndc_x)], dim=-1)
    w = h @ inv_view_proj.T
    den = w[:, 3:4]
    inv = torch.where(torch.abs(den) > 1e-10, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    return w[:, :3] * inv


def kernel_rotation(px: torch.Tensor, py: torch.Tensor):
    """(cos, sin) of the per-pixel kernel rotation, a hash of the pixel
    centre. It depends on the pixel grid alone: a pass computes it once."""
    angle = (px * 12.9898 + py * 78.233) * 43758.5453
    angle = (angle - torch.floor(angle)) * (2.0 * math.pi)
    return torch.cos(angle), torch.sin(angle)


def ssao(
    depth: torch.Tensor,        # (H, W) reverse-Z
    normal_flat: torch.Tensor,  # (N, 3) world normals
    valid_flat: torch.Tensor,   # (N,) coverage
    px: torch.Tensor,
    py: torch.Tensor,
    cam_view_proj: torch.Tensor,
    cam_near: torch.Tensor,
    width: int,
    height: int,
    kernel: np.ndarray,
    radius: float = 0.5,
    bias: float = 0.02,   # metres
    intensity: float = 1.0,
    rotation=None,        # kernel_rotation(px, py), when the caller keeps it
) -> torch.Tensor:
    """(N,) ambient visibility in [0, 1] (1 = unoccluded)."""
    depth_flat = depth.reshape(-1)
    world = reconstruct_world_pos(depth_flat, px, py, inverse4(cam_view_proj), width, height)

    n = normal_flat
    ca, sa = kernel_rotation(px, py) if rotation is None else rotation
    # Helper axis: +Y, or +X where the normal is nearly vertical.
    use_y = (torch.abs(n[:, 1]) < 0.99).to(n.dtype)
    helper = torch.stack([1.0 - use_y, use_y, torch.zeros_like(use_y)], dim=-1)
    t0 = mx.normalize(torch.cross(helper, n, dim=-1))
    b0 = torch.cross(n, t0, dim=-1)
    t = t0 * ca[:, None] + b0 * sa[:, None]
    b = -t0 * sa[:, None] + b0 * ca[:, None]

    sample_h = depth.shape[0]
    occ = torch.zeros_like(depth_flat)
    for k in np.asarray(kernel, np.float32):
        k0, k1, k2 = float(k[0]), float(k[1]), float(k[2])
        sample = world + (t * k0 + b * k1 + n * k2) * radius
        clip = mx.transform_points_h(cam_view_proj, sample)
        w_c = torch.clamp(clip[:, 3], min=1e-6)
        sx = (clip[:, 0] / w_c * 0.5 + 0.5) * width
        sy = (0.5 - clip[:, 1] / w_c * 0.5) * height
        # Cast before the clip: negative coordinates truncate toward zero.
        xi = clamped_index(sx, width)
        yi = clamped_index(sy, sample_h)
        # Reverse-Z with an infinite far plane: view distance = near / depth.
        scene_z = cam_near / torch.clamp(depth_flat[yi * width + xi], min=1e-8)
        # Occluded when the scene surface is in front of the sample point, in
        # view-space metres (w_c is the sample's view distance); occluders
        # far from the sample are faded out.
        occluded = scene_z < w_c - bias
        range_w = torch.clamp(1.0 - torch.abs(scene_z - w_c) / radius, 0.0, 1.0)
        occ = occ + occluded.to(torch.float32) * range_w
    ao = 1.0 - intensity * occ / len(kernel)
    return torch.where(valid_flat, torch.clamp(ao, 0.0, 1.0), 1.0)
