"""Reflection denoiser: reproject -> prefilter -> resolve-temporal over
persistent history (port of arkoserenderer_tpu/ops/reflection_denoise.py).

  * ``reproject``: the history colour, luma moments and depth fetched along
    the motion vectors, with a slope-scaled depth test for disocclusion;
  * ``prefilter``: an edge-aware blur (normal and depth weights, two rings
    of taps) whose strength grows with roughness;
  * ``resolve_temporal``: exponential accumulation with a sample-count ramp,
    the history clamped to the current 3x3 neighbourhood widened by the
    spatial and temporal deviation.

State carried across frames: history colour (H, W, 3), moments (H, W, 3) =
(mean luma, mean luma^2, sample count), previous depth (H, W).

The history is fetched as the reference fetches it, by the same device-side
branch as ``ops/shadow_denoise.history_fetch``: nine weighted static shifts
when the largest motion component is at most a pixel, a bilinear gather
otherwise.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.image import luminance, shift_img
from arkoserenderer_torch.ops.shadow_denoise import history_fetch

RING1 = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1))
RING2 = ((-2, 0), (2, 0), (0, -2), (0, 2), (-2, -2), (-2, 2), (2, -2), (2, 2))


def reproject(history: torch.Tensor, moments_hist: torch.Tensor, prev_depth: torch.Tensor,
              depth: torch.Tensor, velocity: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
              depth_tolerance: float = 2e-3):
    """Returns (hist_color (H, W, 3), hist_moments (H, W, 3), confidence
    (H, W) in {0, 1})."""
    h, w = depth.shape
    vel = velocity.reshape(-1, 2)
    prev_x = px - vel[:, 0]
    prev_y = py - vel[:, 1]
    hist, mom, d_prev = history_fetch((history, moments_hist, prev_depth[..., None]),
                                      velocity, prev_x, prev_y)
    d_prev = d_prev[..., 0]
    on_screen = ((prev_x >= 0.0) & (prev_x < w) & (prev_y >= 0.0) & (prev_y < h)).reshape(h, w)
    d = depth[..., None]
    gx = torch.abs(shift_img(d, 0, 1) - shift_img(d, 0, -1))[..., 0]
    gy = torch.abs(shift_img(d, 1, 0) - shift_img(d, -1, 0))[..., 0]
    grad = 0.5 * torch.maximum(gx, gy)
    tol = 2.0 * grad + depth_tolerance * torch.clamp(torch.abs(depth), min=1e-4) + 1e-5
    depth_ok = torch.abs(d_prev - depth) <= tol
    return hist, mom, (on_screen & depth_ok).to(torch.float32)


def prefilter(refl: torch.Tensor, rough: torch.Tensor, normal: torch.Tensor,
              depth: torch.Tensor, sigma_n: float = 32.0, depth_sigma: float = 4e-3):
    """Edge-aware spatial blur of (H, W, 3) reflections; ``rough`` (H, W, 1)
    gates it (mirrors pass through, full blur by roughness 0.3)."""
    d = depth[..., None]
    acc = refl
    wacc = torch.ones_like(d)
    for ring, offs in ((1.0, RING1), (0.5, RING2)):
        for dy, dx in offs:
            c = shift_img(refl, dy, dx)
            n = shift_img(normal, dy, dx)
            dd = shift_img(d, dy, dx)
            w_n = torch.clamp(torch.sum(n * normal, -1, keepdim=True), min=0.0) ** sigma_n
            w_d = torch.exp(-torch.abs(dd - d) / depth_sigma)
            wt = ring * w_n * w_d
            acc = acc + c * wt
            wacc = wacc + wt
    blurred = acc / wacc
    gate = torch.clamp(rough / 0.3, 0.0, 1.0)
    return refl + (blurred - refl) * gate


def resolve_temporal(filtered: torch.Tensor, hist: torch.Tensor, mom_hist: torch.Tensor,
                     confidence: torch.Tensor, first_frame, max_samples: float = 16.0,
                     gamma: float = 1.2):
    """Variance-clamped accumulation; returns (resolved, new_moments)."""
    s1 = filtered
    s2 = filtered * filtered
    s_min = filtered
    s_max = filtered
    cnt = 1.0
    for dy, dx in RING1:
        c = shift_img(filtered, dy, dx)
        s1 = s1 + c
        s2 = s2 + c * c
        s_min = torch.minimum(s_min, c)
        s_max = torch.maximum(s_max, c)
        cnt += 1.0
    mu = s1 / cnt
    sigma = torch.sqrt(torch.clamp(s2 / cnt - mu * mu, min=0.0))
    sigma_t = torch.sqrt(torch.clamp(mom_hist[..., 1:2] - mom_hist[..., 0:1] ** 2, min=0.0))
    eps = gamma * sigma + 1.5 * sigma_t + 0.05 * mu + 1e-4
    hist_clamped = torch.minimum(torch.maximum(hist, s_min - eps), s_max + eps)

    conf = confidence[..., None]
    if isinstance(first_frame, torch.Tensor):  # a device scalar: no host branch
        reset = torch.maximum(1.0 - conf, (first_frame != 0).to(torch.float32))
    else:
        reset = torch.clamp(1.0 - conf, min=1.0 if first_frame else 0.0)
    n_prev = mom_hist[..., 2:3] * (1.0 - reset)
    n = torch.clamp(n_prev + 1.0, max=max_samples)
    alpha = 1.0 / n
    resolved = hist_clamped + (filtered - hist_clamped) * alpha
    fresh = reset > 0.5
    resolved = torch.where(fresh, filtered, resolved)

    luma = luminance(resolved)
    m1 = mom_hist[..., 0:1] * (1.0 - alpha) + luma * alpha
    m2 = mom_hist[..., 1:2] * (1.0 - alpha) + luma * luma * alpha
    m1 = torch.where(fresh, luma, m1)
    m2 = torch.where(fresh, luma * luma, m2)
    return resolved, torch.cat([m1, m2, n], dim=-1)
