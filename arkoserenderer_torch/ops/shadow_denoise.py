"""Sigma-style denoiser of stochastic shadow masks, the reference's NRD
slot (port of arkoserenderer_tpu/ops/shadow_denoise.py: ``initial_moments``,
``normals_from_depth``, ``camera_velocity``, ``reproject``, ``prefilter``,
``resolve_temporal`` and ``denoise``).

One ray a pixel a frame toward a point of the sun's disk or of a light's
disk gives a noisy visibility; the denoiser reprojects last frame's
resolved masks, filters the noisy ones where their temporal variance says
they flicker, and accumulates. It works on a stack of C scalar planes on
the last axis (the sun's mask, C = 1, or the soft local lights'), which
share one reprojection:

  * ``reproject``: the masks, their moments and last frame's depth fetched
    along the motion vectors, with a slope-scaled depth test;
  * ``prefilter``: a cross-bilateral blur (normal, depth and history-mean
    weights over two rings) gated by each plane's temporal deviation, so
    settled pixels pass through and penumbra pixels blur;
  * ``resolve_temporal``: variance-clamped exponential accumulation per
    plane with a shared sample-count ramp; the moments track the raw masks.

State of a stack: masks (H, W, C), moments (H, W, 2C + 1) laid out
[m1 x C, m2 x C, count], previous depth (H, W).

The reference fetches the history with nine weighted static shifts when the
largest motion is under a pixel (a branch on a device value) and with a
bilinear gather otherwise; the port always gathers, which is the same
bilinear filter rounded in another order (as ``ops/reflection_denoise``).
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.image import bilinear_sample_many, shift_img

RING1 = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1))
RING2 = ((-2, 0), (2, 0), (0, -2), (0, 2), (-2, -2), (-2, 2), (2, -2), (2, 2))


def initial_moments(h: int, w: int, c: int, device="cuda") -> torch.Tensor:
    """Zero-sample moments [m1 x C, m2 x C, count]."""
    return torch.zeros((h, w, 2 * c + 1), dtype=torch.float32, device=device)


def normals_from_depth(world: torch.Tensor) -> torch.Tensor:
    """Geometric normals (H, W, 3) from reconstructed world positions, by
    central differences (the shadow passes run before the shading pass
    publishes SceneNormal). The sign is view-consistent, which is all the
    similarity weight needs."""
    dx = shift_img(world, 0, 1) - shift_img(world, 0, -1)
    dy = shift_img(world, 1, 0) - shift_img(world, -1, 0)
    n = torch.cross(dy, dx, dim=-1)
    return n / torch.sqrt(torch.clamp(torch.sum(n * n, -1, keepdim=True), min=1e-20))


def camera_velocity(world: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                    prev_view_proj: torch.Tensor, width: int, frame_height: int) -> torch.Tensor:
    """(H, W, 2) screen motion in pixels (current - previous) of the
    camera alone, from the world positions (H, W, 3) and pixel centres (N,)."""
    h, w = world.shape[:2]
    wp = world.reshape(-1, 3)
    clip = torch.cat([wp, torch.ones((wp.shape[0], 1), dtype=wp.dtype, device=wp.device)], -1)
    clip = clip @ prev_view_proj.T
    den = clip[:, 3:4]
    inv = torch.where(torch.abs(den) > 1e-10, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    ndc = clip[:, :2] * inv
    px_prev = (ndc[:, 0] * 0.5 + 0.5) * width
    py_prev = (0.5 - ndc[:, 1] * 0.5) * frame_height
    return torch.stack([px - px_prev, py - py_prev], -1).reshape(h, w, 2)


def reproject(hist: torch.Tensor, mom_hist: torch.Tensor, prev_depth: torch.Tensor,
              depth: torch.Tensor, velocity: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
              depth_tolerance: float = 2e-3):
    """Returns (hist (H, W, C), mom_hist (H, W, 2C + 1), confidence (H, W)
    in {0, 1}) at the current pixels."""
    h, w = depth.shape
    vel = velocity.reshape(-1, 2)
    prev_x = px - vel[:, 0]
    prev_y = py - vel[:, 1]
    hist_r, mom_r, d_prev = bilinear_sample_many((hist, mom_hist, prev_depth[..., None]),
                                                 prev_x, prev_y)
    hist_r = hist_r.reshape(h, w, hist.shape[-1])
    mom_r = mom_r.reshape(h, w, mom_hist.shape[-1])
    d_prev = d_prev.reshape(h, w)
    on_screen = ((prev_x >= 0.0) & (prev_x < w) & (prev_y >= 0.0) & (prev_y < h)).reshape(h, w)
    # Slope-scaled disocclusion test: grazing surfaces survive sub-pixel
    # motion, a step to another surface trips it.
    d = depth[..., None]
    gx = torch.abs(shift_img(d, 0, 1) - shift_img(d, 0, -1))[..., 0]
    gy = torch.abs(shift_img(d, 1, 0) - shift_img(d, -1, 0))[..., 0]
    grad = 0.5 * torch.maximum(gx, gy)
    tol = 2.0 * grad + depth_tolerance * torch.clamp(torch.abs(depth), min=1e-4) + 1e-5
    depth_ok = torch.abs(d_prev - depth) <= tol
    return hist_r, mom_r, (on_screen & depth_ok).to(torch.float32)


def prefilter(mask: torch.Tensor, normal: torch.Tensor, depth: torch.Tensor,
              mom_hist: torch.Tensor, sigma_n: float = 16.0,
              depth_sigma: float = 4e-3) -> torch.Tensor:
    """Variance-guided cross-bilateral blur of the (H, W, C) noisy masks.
    The gate is each plane's temporal deviation (a flickering penumbra
    pixel blurs, a settled one passes through exactly), plus the 3x3
    spatial deviation faded out by the accumulated sample count."""
    c = mask.shape[-1]
    d = depth[..., None]
    m1 = mom_hist[..., :c]
    m2 = mom_hist[..., c:2 * c]
    n_acc = mom_hist[..., 2 * c:2 * c + 1]
    sigma_t = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))

    acc = mask
    s1 = mask
    s2 = mask * mask
    cnt = 1.0
    wacc = torch.ones_like(mask)
    for ring, offs in ((1.0, RING1), (0.5, RING2)):
        for dy, dx in offs:
            m = shift_img(mask, dy, dx)
            n = shift_img(normal, dy, dx)
            dd = shift_img(d, dy, dx)
            m1_t = shift_img(m1, dy, dx)
            w_n = torch.clamp(torch.sum(n * normal, -1, keepdim=True), min=0.0) ** sigma_n
            w_d = torch.exp(-torch.abs(dd - d) / depth_sigma)
            # History-mean similarity: taps from another band of the
            # penumbra weigh less, so the blur keeps its gradient.
            w_m = torch.exp(-torch.abs(m1_t - m1) / 0.15)
            wt = ring * w_n * w_d * w_m
            acc = acc + m * wt
            wacc = wacc + wt
            if ring == 1.0:
                s1 = s1 + m
                s2 = s2 + m * m
                cnt += 1.0
    blurred = acc / wacc
    mu = s1 / cnt
    sigma_s = torch.sqrt(torch.clamp(s2 / cnt - mu * mu, min=0.0))
    cold = 1.0 / (1.0 + n_acc)  # 1 on the first frame, ~0 once accumulated
    gate = torch.clamp(sigma_t / 0.1 + (sigma_s / 0.1) * cold, 0.0, 1.0)
    return mask + (blurred - mask) * gate


def resolve_temporal(filtered: torch.Tensor, raw: torch.Tensor, hist: torch.Tensor,
                     mom_hist: torch.Tensor, confidence: torch.Tensor, first_frame,
                     max_samples: float = 24.0, gamma: float = 1.0):
    """Variance-clamped accumulation per plane with a shared sample-count
    ramp; returns (resolved in [0, 1], new moments). The moments track the
    RAW masks: moments of the filtered ones would keep the prefilter's gate
    open wherever it once blurred."""
    c = filtered.shape[-1]
    s1 = filtered
    s2 = filtered * filtered
    s_min = filtered
    s_max = filtered
    cnt = 1.0
    for dy, dx in RING1:
        m = shift_img(filtered, dy, dx)
        s1 = s1 + m
        s2 = s2 + m * m
        s_min = torch.minimum(s_min, m)
        s_max = torch.maximum(s_max, m)
        cnt += 1.0
    mu = s1 / cnt
    sigma = torch.sqrt(torch.clamp(s2 / cnt - mu * mu, min=0.0))
    m1_h = mom_hist[..., :c]
    m2_h = mom_hist[..., c:2 * c]
    sigma_t = torch.sqrt(torch.clamp(m2_h - m1_h * m1_h, min=0.0))
    # The temporal deviation widens the box in penumbras, so the history
    # settles on the mean visibility; the epsilon lets real changes in.
    eps = gamma * sigma + 1.5 * sigma_t + 0.02
    hist_clamped = torch.minimum(torch.maximum(hist, s_min - eps), s_max + eps)

    conf = confidence[..., None]
    if isinstance(first_frame, torch.Tensor):
        reset = torch.maximum(1.0 - conf, (first_frame != 0).to(torch.float32))
    else:
        reset = torch.clamp(1.0 - conf, min=1.0 if first_frame else 0.0)
    n_prev = mom_hist[..., 2 * c:2 * c + 1] * (1.0 - reset)
    n = torch.clamp(n_prev + 1.0, max=max_samples)
    alpha = 1.0 / n
    resolved = hist_clamped + (filtered - hist_clamped) * alpha
    fresh = reset > 0.5
    resolved = torch.clamp(torch.where(fresh, filtered, resolved), 0.0, 1.0)

    m1 = m1_h * (1.0 - alpha) + raw * alpha
    m2 = m2_h * (1.0 - alpha) + raw * raw * alpha
    m1 = torch.where(fresh, raw, m1)
    m2 = torch.where(fresh, raw * raw, m2)
    return resolved, torch.cat([m1, m2, n], dim=-1)


def denoise(noisy: torch.Tensor, depth: torch.Tensor, normal: torch.Tensor,
            velocity: torch.Tensor, hist: torch.Tensor, mom_hist: torch.Tensor,
            prev_depth: torch.Tensor, px: torch.Tensor, py: torch.Tensor, first_frame):
    """reproject -> prefilter -> resolve; returns (resolved (H, W, C), new
    moments (H, W, 2C + 1))."""
    hist_r, mom_r, conf = reproject(hist, mom_hist, prev_depth, depth, velocity, px, py)
    filtered = prefilter(noisy, normal, depth, mom_r)
    return resolve_temporal(filtered, noisy, hist_r, mom_r, conf, first_frame)
