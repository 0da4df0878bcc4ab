"""Post-process image functions: fog, motion blur, depth of field, FXAA, CAS
(port of arkoserenderer_tpu/ops/postprocess.py).

  * fog            exponential height fog along the view distance
  * motion blur    McGuire-style tileMax -> neighborMax -> reconstruction
  * depth of field physically based circle of confusion + bokeh gather blur
  * FXAA           luma-driven edge blend on the LDR image
  * CAS            contrast-adaptive sharpening on the LDR image

Motion blur and depth of field have a dense branch (every tap a bilinear
fetch) and a stochastic one (a few jittered nearest taps, drawn from the
frame's blue noise, whose expectation is the dense result; TAA converges
them), which the temporal passes take.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from arkoserenderer_torch.core.halton import fibonacci_disc
from arkoserenderer_torch.ops.image import bilinear_sample_many, luminance, shift_img
from arkoserenderer_torch.ops.noise import MASK32, frame_word, mul_u32, sample_blue_noise


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _pixel_centers(h: int, w: int, device):
    """(N,) px, (N,) py pixel-centre coordinates of an (H, W) image."""
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    return xs.repeat(h), ys.repeat_interleave(w)


def _nearest_sample_many(imgs, x: torch.Tensor, y: torch.Tensor) -> list[torch.Tensor]:
    """Nearest fetch of several (H, W, C_i) images of one size at pixel-centre
    coordinates (clamped): one index for all, each image gathered apart
    (``ops/image.bilinear_sample_many`` says why). With a uniform jitter in
    [-0.5, 0.5) added to the coordinates its expectation is the bilinear
    fetch: the stochastic taps' primitive."""
    h, w = imgs[0].shape[0], imgs[0].shape[1]
    xi = torch.clamp(torch.round(x - 0.5).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(y - 0.5).to(torch.int64), 0, h - 1)
    idx = yi * w + xi
    return [img.reshape(-1, img.shape[-1])[idx] for img in imgs]


def _nearest_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``_nearest_sample_many`` of one image: (N, C)."""
    return _nearest_sample_many((img,), x, y)[0]


def _pixel_noise(px, py, frame_index: int, salt: int) -> torch.Tensor:
    """Per-pixel blue noise of the frame (``ops/noise.sample_blue_noise``)."""
    return sample_blue_noise(px, py, frame_index, salt)


def _white_pixel_noise(px, py, frame_index: int, salt: int) -> torch.Tensor:
    """The reference's integer-hash white noise in [0, 1): its uint32
    arithmetic in int64 words, masked to 32 bits after every multiply and
    add."""
    fi = frame_word(frame_index)
    seed = ((px.to(torch.int64) & MASK32) + mul_u32(py.to(torch.int64) & MASK32, 19349663)
            + ((fi * 83492791) & MASK32) + ((salt * 374761393) & MASK32)) & MASK32
    seed = seed ^ (seed >> 16)
    seed = mul_u32(seed, 0x7FEB352D)
    seed = seed ^ (seed >> 15)
    seed = mul_u32(seed, 0x846CA68B)
    seed = seed ^ (seed >> 16)
    return (seed >> 8).to(torch.float32) * (1.0 / 16777216.0)


def apply_fog(
    color: torch.Tensor,      # (H, W, 3)
    world_pos: torch.Tensor,  # (H, W, 3) reconstructed
    valid: torch.Tensor,      # (H, W) geometry coverage
    cam_pos: torch.Tensor,    # (3,)
    fog_color: torch.Tensor,  # (3,) pre-exposed
    density: float = 0.02,
    height_falloff: float = 0.1,
    base_height: float = 0.0,
) -> torch.Tensor:
    """Exponential height fog along the view distance."""
    dist = _norm(world_pos - cam_pos)
    h = world_pos[..., 1] - base_height
    height_term = torch.exp(-height_falloff * torch.clamp(h, min=0.0))
    transmittance = torch.exp(-density * dist * height_term)
    transmittance = torch.where(valid, transmittance, 1.0)[..., None]
    return color * transmittance + fog_color * (1.0 - transmittance)


def motion_blur(
    color: torch.Tensor,     # (H, W, 3)
    velocity: torch.Tensor,  # (H, W, 2) pixels per frame
    depth: torch.Tensor,     # (H, W) reverse-Z (unused by the filter)
    shutter_scale: float = 0.5,   # 180-degree shutter
    tile: int = 16,
    num_taps: int = 8,
    max_blur_px: float = 24.0,
    stochastic: bool = False,  # jittered nearest taps (2 are plenty) + TAA
    frame_index: int = 0,
) -> torch.Tensor:
    """Blur along the dominant velocity of each pixel's tile neighbourhood;
    H and W must be multiples of ``tile``. ``stochastic``: each of the
    ``num_taps`` taps is one nearest fetch at a stratified jittered shutter
    position plus a sub-texel jitter (blue noise of ``frame_index``, salts
    11+i, 21+i and 31+i), weighted as 8 / num_taps dense taps."""
    h, w = color.shape[0], color.shape[1]
    vel = velocity * shutter_scale
    speed = _norm(vel, keepdim=True)
    vel = vel * (torch.clamp(speed, max=max_blur_px) / torch.clamp(speed, min=1e-6))

    # tileMax: the fastest velocity of each tile; then neighborMax over the
    # 3x3 tiles around it.
    th, tw = h // tile, w // tile
    v_tiles = vel.reshape(th, tile, tw, tile, 2).permute(0, 2, 1, 3, 4).reshape(
        th, tw, tile * tile, 2)
    idx = torch.argmax(_norm(v_tiles), dim=-1)  # the first of equal maxima
    tile_max = torch.take_along_dim(v_tiles, idx[..., None, None].expand(th, tw, 1, 2), dim=2)[
        :, :, 0]
    neighbor = tile_max
    best = _norm(tile_max)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cand = shift_img(tile_max, dy, dx)
            cs = _norm(cand)
            neighbor = torch.where((cs > best)[..., None], cand, neighbor)
            best = torch.maximum(best, cs)
    nv = neighbor.repeat_interleave(tile, dim=0).repeat_interleave(tile, dim=1).reshape(-1, 2)

    px, py = _pixel_centers(h, w, color.device)
    acc = color.reshape(-1, 3)
    wsum = torch.ones((acc.shape[0], 1), dtype=color.dtype, device=color.device)
    for i in range(num_taps):
        if stochastic:
            u = _pixel_noise(px, py, frame_index, 11 + i)
            t = (i + u) / num_taps - 0.5
            jx = _pixel_noise(px, py, frame_index, 21 + i) - 0.5
            jy = _pixel_noise(px, py, frame_index, 31 + i) - 0.5
            c, tap_vel = _nearest_sample_many((color, vel), px + nv[:, 0] * t + jx,
                                              py + nv[:, 1] * t + jy)
        else:
            t = (i + 1) / (num_taps + 1) - 0.5  # [-0.5, 0.5)
            c, tap_vel = bilinear_sample_many((color, vel), px + nv[:, 0] * t,
                                              py + nv[:, 1] * t)
        wgt = torch.clamp(_norm(tap_vel, keepdim=True), max=1.0)
        if stochastic:
            # Each jittered tap stands for 8 / num_taps dense taps, which
            # keeps the centre's weight against the taps.
            wgt = wgt * (8.0 / num_taps)
        acc = acc + c * wgt
        wsum = wsum + wgt
    return (acc / wsum).reshape(h, w, 3)


def compute_coc(
    depth: torch.Tensor,        # (H, W) reverse-Z
    valid: torch.Tensor,        # (H, W)
    near: torch.Tensor,         # () camera near
    focus_depth: torch.Tensor,  # () metres
    aperture_px: torch.Tensor,  # () CoC scale (CameraState.aperture_px)
    max_coc: float = 16.0,
) -> torch.Tensor:
    """Signed circle of confusion in pixels (negative = in front of focus),
    from the infinite-far reverse-Z inversion z_view = near / depth."""
    z = near / torch.clamp(depth, min=1e-8)  # view-space distance, metres
    signed = aperture_px * (z - focus_depth) / torch.clamp(z, min=1e-4)
    signed = torch.where(valid, signed, max_coc)  # background blurs fully
    return torch.clamp(signed, -max_coc, max_coc)


def depth_of_field(color: torch.Tensor, coc: torch.Tensor, num_taps: int = 24,
                   stochastic_taps: int | None = None, frame_index: int = 0) -> torch.Tensor:
    """Scatter-as-gather bokeh blur of (H, W, 3) by a signed (H, W) CoC: disc
    taps scaled by |CoC|, each weighted by whether its own CoC reaches back
    to the centre pixel. ``stochastic_taps``: that many nearest taps of the
    Fibonacci disc instead, rotated per pixel (blue-noise salt 41) with an
    area-preserving radius jitter (salts 51+i) and each weighted as
    num_taps / stochastic_taps dense taps."""
    h, w = color.shape[0], color.shape[1]
    px, py = _pixel_centers(h, w, color.device)
    r = torch.abs(coc).reshape(-1)
    acc = color.reshape(-1, 3)
    wsum = torch.ones((acc.shape[0], 1), dtype=color.dtype, device=color.device)
    coc1 = coc[..., None]
    if stochastic_taps:
        abs_coc = torch.abs(coc1)
        ang = _pixel_noise(px, py, frame_index, 41) * (2.0 * math.pi)
        ca, sa = torch.cos(ang), torch.sin(ang)
        base = fibonacci_disc(stochastic_taps).astype(np.float32)
        for i in range(stochastic_taps):
            b0, b1 = base[i]
            u = _pixel_noise(px, py, frame_index, 51 + i)
            rad = r * torch.sqrt(torch.clamp(float(b0 * b0 + b1 * b1)
                                             + (u - 0.5) * (2.0 / stochastic_taps), 0.0, 1.0))
            phi = np.arctan2(b1, b0)
            cp, sp = float(np.cos(phi)), float(np.sin(phi))
            dx = rad * (cp * ca - sp * sa)
            dy = rad * (sp * ca + cp * sa)
            dist = torch.sqrt(dx * dx + dy * dy)
            c, tap_coc = _nearest_sample_many((color, abs_coc), px + dx, py + dy)
            wgt = torch.clamp(tap_coc - dist[:, None] + 1.0, 0.0, 1.0)
            wgt = wgt * (num_taps / stochastic_taps)
            acc = acc + c * wgt
            wsum = wsum + wgt
        return (acc / wsum).reshape(h, w, 3)
    for tap_x, tap_y in fibonacci_disc(num_taps).tolist():
        dx = tap_x * r
        dy = tap_y * r
        dist = torch.sqrt(dx * dx + dy * dy)
        c, tap_coc = bilinear_sample_many((color, coc1), px + dx, py + dy)
        wgt = torch.clamp(torch.abs(tap_coc) - dist[:, None] + 1.0, 0.0, 1.0)
        acc = acc + c * wgt
        wsum = wsum + wgt
    return (acc / wsum).reshape(h, w, 3)


def fxaa_active_mask(ldr: torch.Tensor, edge_threshold: float = 0.125,
                     min_threshold: float = 0.0312) -> torch.Tensor:
    """(H, W) bool: the pixels FXAA blends, where the luma contrast of the
    4-neighbour cross is at least max(min_threshold, its max * edge_threshold)."""
    return _fxaa_lumas(ldr, edge_threshold, min_threshold)[-1]


def _fxaa_lumas(ldr, edge_threshold, min_threshold):
    """(centre, N, S, E, W luma, the active mask) of (H, W, 3)."""
    l_c = luminance(ldr)[..., 0]
    l_n = shift_img(l_c, -1, 0)
    l_s = shift_img(l_c, 1, 0)
    l_e = shift_img(l_c, 0, 1)
    l_w = shift_img(l_c, 0, -1)
    l_min = torch.minimum(l_c, torch.minimum(torch.minimum(l_n, l_s), torch.minimum(l_e, l_w)))
    l_max = torch.maximum(l_c, torch.maximum(torch.maximum(l_n, l_s), torch.maximum(l_e, l_w)))
    contrast = l_max - l_min
    return l_c, l_n, l_s, l_e, l_w, contrast >= torch.clamp(l_max * edge_threshold,
                                                            min=min_threshold)


def fxaa(ldr: torch.Tensor, edge_threshold: float = 0.125,
         min_threshold: float = 0.0312) -> torch.Tensor:
    """Luma-driven edge anti-aliasing on the final (H, W, 3) LDR image."""
    l_c, l_n, l_s, l_e, l_w, active = _fxaa_lumas(ldr, edge_threshold, min_threshold)

    # Blur direction perpendicular to the luma gradient.
    horiz = (torch.abs(l_n + l_s - 2 * l_c) >= torch.abs(l_e + l_w - 2 * l_c))[..., None]
    blur_a = torch.where(horiz, shift_img(ldr, -1, 0), shift_img(ldr, 0, -1))
    blur_b = torch.where(horiz, shift_img(ldr, 1, 0), shift_img(ldr, 0, 1))
    blended = 0.5 * ldr + 0.25 * (blur_a + blur_b)
    return torch.where(active[..., None], blended, ldr)


def cas(ldr: torch.Tensor, sharpness: float = 0.5) -> torch.Tensor:
    """Contrast-adaptive 3x3 sharpen (AMD FFX-CAS style) on the LDR image."""
    n = shift_img(ldr, -1, 0)
    s = shift_img(ldr, 1, 0)
    e = shift_img(ldr, 0, 1)
    w_ = shift_img(ldr, 0, -1)
    lo = torch.minimum(torch.minimum(n, s), torch.minimum(torch.minimum(e, w_), ldr))
    hi = torch.maximum(torch.maximum(n, s), torch.maximum(torch.maximum(e, w_), ldr))
    # Per-pixel adaptive weight from the local contrast headroom.
    amp = torch.sqrt(torch.clamp(torch.minimum(lo, 1.0 - hi) / torch.clamp(hi, min=1e-4),
                                 0.0, 1.0))
    w_k = amp * (-1.0 / (8.0 - 3.0 * sharpness))
    out = (ldr + w_k * (n + s + e + w_)) / (1.0 + 4.0 * w_k)
    return torch.clamp(out, 0.0, 1.0)
