"""Screen-space ambient occlusion, hemisphere kernel (port of
arkoserenderer_tpu/ops/ssao.py).

N hemisphere samples oriented by the pixel normal are projected back into
the depth buffer; a sample is occluded when the scene surface lies in front
of it, weighted by a range check. The kernel is rotated per pixel by a hash
of the pixel centre; the pass blurs the result 3x3 to hide that noise.
With ``samples_per_frame`` M < N each pixel takes M kernel rows a frame,
picked by an integer hash of the pixel and the frame (temporal SSAO: the
expectation is the N-sample estimate, and TAA converges it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.constants import device_constant
from arkoserenderer_torch.core.halton import halton_sequence_2d
from arkoserenderer_torch.ops.image import clamped_index
from arkoserenderer_torch.ops.noise import MASK32, frame_word, mul_u32


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
    samples_per_frame: int | None = None,  # a hashed subset of the kernel a frame
    frame_index: int = 0,
    sample_depth: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N,) ambient visibility in [0, 1] (1 = unoccluded).

    ``sample_depth``: the whole frame's (full_h, W) depth for the occlusion
    fetches when ``depth`` is one band of it (pixel-band sharding: a
    sample may land in a neighbouring band); ``py`` and ``height`` are then
    the frame's rows."""
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

    depth_img = depth if sample_depth is None else sample_depth
    sample_h = depth_img.shape[0]
    fetch = depth_img.reshape(-1)
    kern = device_constant(("ssao kernel", np.asarray(kernel, np.float32).tobytes()),
                           lambda: np.asarray(kernel, np.float32), depth.device)
    n_samples = kern.shape[0]

    def occlusion(k0, k1, k2):
        sample = world + (t * k0 + b * k1 + n * k2) * radius
        clip = mx.transform_points_h(cam_view_proj, sample)
        w_c = torch.clamp(clip[:, 3], min=1e-6)
        sx = (clip[:, 0] / w_c * 0.5 + 0.5) * width
        sy = (0.5 - clip[:, 1] / w_c * 0.5) * height
        # Cast before the clip: negative coordinates truncate toward zero.
        xi = clamped_index(sx, width)
        yi = clamped_index(sy, sample_h)
        # Reverse-Z with an infinite far plane: view distance = near / depth.
        scene_z = cam_near / torch.clamp(fetch[yi * width + xi], min=1e-8)
        # Occluded when the scene surface is in front of the sample point, in
        # view-space metres (w_c is the sample's view distance); occluders
        # far from the sample are faded out.
        occluded = scene_z < w_c - bias
        range_w = torch.clamp(1.0 - torch.abs(scene_z - w_c) / radius, 0.0, 1.0)
        return occluded.to(torch.float32) * range_w

    occ = torch.zeros_like(depth_flat)
    if samples_per_frame is not None and samples_per_frame < n_samples:
        # The reference's hash: an int32 sum that wraps, cast to uint32,
        # then uint32 multiplies; here int64 words masked to 32 bits.
        seed = (px.to(torch.int64) * 7 + py.to(torch.int64) * 73856093
                + frame_word(frame_index) * 19349663) & MASK32
        for j in range(samples_per_frame):
            h_ = mul_u32((seed + ((j * 374761393) & MASK32)) & MASK32, 0x9E3779B1)
            h_ = mul_u32(h_ ^ (h_ >> 16), 0x85EBCA6B)
            k3 = kern[((h_ >> 8) % n_samples)]
            occ = occ + occlusion(k3[:, 0:1], k3[:, 1:2], k3[:, 2:3])
        occ = occ * (n_samples / samples_per_frame)
    else:
        for k in np.asarray(kernel, np.float32):
            occ = occ + occlusion(float(k[0]), float(k[1]), float(k[2]))
    ao = 1.0 - intensity * occ / n_samples
    return torch.where(valid_flat, torch.clamp(ao, 0.0, 1.0), 1.0)
