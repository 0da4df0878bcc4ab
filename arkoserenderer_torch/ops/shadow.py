"""Shadow maps: light-space projection, variance shadow maps for the sun and
disc PCF for the spot lights (port of arkoserenderer_tpu/ops/shadow.py).

The depth-only raster of the sun's view (ops/raster) is turned into
prefiltered moments (E[d], E[d^2]) at half resolution; receivers take one
bilinear (or one jittered nearest) moment tap and a Chebyshev bound. A spot
light's map is compared directly, over a Fibonacci disc of nearest taps.
Depth is reverse-Z throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from arkoserenderer_torch.core.halton import fibonacci_disc
from arkoserenderer_torch.core.mathx import transform_point_lanes
from arkoserenderer_torch.ops.image import clamped_index


def project_to_shadow_uv(shadow_vp: torch.Tensor, world_pos: torch.Tensor):
    """(4,4) light view-proj + (N,3) world pos -> uv (N,2) in [0,1], depth (N,)."""
    cx, cy, cz, w = transform_point_lanes(shadow_vp, world_pos)
    inv_w = torch.where(torch.abs(w) > 1e-12, 1.0 / torch.where(w == 0, 1.0, w), 0.0)
    uv = torch.stack([cx * inv_w * 0.5 + 0.5, 0.5 - cy * inv_w * 0.5], dim=-1)
    return uv, cz * inv_w


def _fetch_shadow_depth(shadow_map: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Nearest fetch with clamp from an (S, S) reverse-Z depth map. The
    texel index is cast before it is clipped, so it truncates toward zero."""
    s = shadow_map.shape[0]
    return shadow_map.reshape(-1)[clamped_index(v * s, s) * s + clamped_index(u * s, s)]


def sample_shadow_pcf(
    shadow_map: torch.Tensor,  # (S, S)
    shadow_vp: torch.Tensor,
    world_pos: torch.Tensor,   # (N, 3)
    n_dot_l: torch.Tensor,
    constant_bias: float = 1.5e-3,
    slope_bias: float = 3.5e-3,
    radius_texels: float = 1.5,
    num_taps: int = 8,
) -> torch.Tensor:
    """(N,) shadow visibility in [0, 1], 1 = fully lit: the share of disc
    taps whose stored depth the receiver's biased depth reaches (reverse-Z:
    the closest occluder has the largest depth). The slope bias grows with
    tan(acos(n.l)). Outside the light's frustum everything is lit."""
    s = shadow_map.shape[0]
    uv, depth = project_to_shadow_uv(shadow_vp, world_pos)
    slope = torch.sqrt(torch.clamp(1.0 - n_dot_l ** 2, min=0.0)) / torch.clamp(n_dot_l, min=0.1)
    biased = depth + (constant_bias + slope_bias * torch.clamp(slope, 0.0, 3.0))
    taps = fibonacci_disc(num_taps) * (radius_texels / s)  # float32
    lit = torch.zeros_like(depth)
    for du, dv in taps.tolist():
        occ = _fetch_shadow_depth(shadow_map, uv[:, 0] + du, uv[:, 1] + dv)
        lit = lit + (biased >= occ).to(depth.dtype)
    inside = (uv[:, 0] > 0.0) & (uv[:, 0] < 1.0) & (uv[:, 1] > 0.0) & (uv[:, 1] < 1.0)
    return torch.where(inside, lit / num_taps, 1.0)


def shadow_moments(depth_map: torch.Tensor, blur_passes: int = 2,
                   downsample: int = 2) -> torch.Tensor:
    """(S, S) reverse-Z depth -> (S/k, S/k, 2) prefiltered (E[d], E[d^2]).

    A k x k block mean (exact VSM prefiltering), then ``blur_passes`` 3x3
    box blurs with zero padding at the border (the reference's SAME
    reduce_window), each a sum times 1/9."""
    k = downsample
    planes = torch.stack([depth_map, depth_map * depth_map])[None]  # (1, 2, S, S)
    if k > 1 and depth_map.shape[0] % k == 0 and depth_map.shape[1] % k == 0:
        planes = F.avg_pool2d(planes, k, stride=k, divisor_override=1) * (1.0 / (k * k))
    for _ in range(blur_passes):
        planes = F.avg_pool2d(planes, 3, stride=1, padding=1, divisor_override=1) * (1.0 / 9.0)
    return planes[0].permute(1, 2, 0).contiguous()


def sample_vsm(
    moments: torch.Tensor,     # (S, S, 2)
    shadow_vp: torch.Tensor,
    world_pos: torch.Tensor,   # (N, 3)
    n_dot_l: torch.Tensor,
    constant_bias: float = 1.5e-3,
    slope_bias: float = 2.0e-3,
    min_variance: float = 1e-6,
    bleed_reduction: float = 0.25,
    taps: str = "bilinear",                # | "stochastic"
    noise2: torch.Tensor | None = None,    # (N, 2) in [0, 1): the stochastic tap's draws
) -> torch.Tensor:
    """(N,) sun visibility from one moment tap (Chebyshev upper bound, light
    bleeding clipped by rescaling the tail). The tap is bilinear, or with
    ``taps="stochastic"`` and ``noise2`` one jittered nearest texel,
    round(x + u - 0.5) per axis, whose expectation is the bilinear tap."""
    s = moments.shape[0]
    uv, depth = project_to_shadow_uv(shadow_vp, world_pos)
    slope = torch.sqrt(torch.clamp(1.0 - n_dot_l ** 2, min=0.0)) / torch.clamp(n_dot_l, min=0.1)
    bias = constant_bias + slope_bias * torch.clamp(slope, 0.0, 3.0)
    d = depth + bias

    x = torch.clamp(uv[:, 0] * s - 0.5, 0.0, s - 1.0)
    y = torch.clamp(uv[:, 1] * s - 0.5, 0.0, s - 1.0)
    flat = moments.reshape(-1, 2)
    last = flat.shape[0] - 1

    def tap(yi, xi):  # clamped like the reference's gather (NaN uv only)
        return flat[torch.clamp(yi * s + xi, 0, last)]

    if taps == "stochastic" and noise2 is not None:
        xi = torch.clamp(torch.round(x + noise2[:, 0] - 0.5), 0.0, s - 1.0).to(torch.int64)
        yi = torch.clamp(torch.round(y + noise2[:, 1] - 0.5), 0.0, s - 1.0).to(torch.int64)
        m = tap(yi, xi)
    else:
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        x1i = torch.clamp(x0i + 1, max=s - 1)
        y1i = torch.clamp(y0i + 1, max=s - 1)
        m00, m10 = tap(y0i, x0i), tap(y0i, x1i)
        m01, m11 = tap(y1i, x0i), tap(y1i, x1i)
        m = (m00 * (1 - fx) + m10 * fx) * (1 - fy) + (m01 * (1 - fx) + m11 * fx) * fy

    mean = m[:, 0]
    var = torch.clamp(m[:, 1] - mean * mean, min=min_variance)
    diff = mean - d
    p = var / (var + diff * diff)
    p = torch.clamp((p - bleed_reduction) / (1.0 - bleed_reduction), 0.0, 1.0)
    lit = torch.where(d >= mean, 1.0, p)
    inside = (uv[:, 0] > 0.0) & (uv[:, 0] < 1.0) & (uv[:, 1] > 0.0) & (uv[:, 1] < 1.0)
    return torch.where(inside, lit, 1.0)
