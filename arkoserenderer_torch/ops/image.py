"""Image-space helpers: bilinear and Catmull-Rom resampling, the 2x pyramid
steps and 3x3 stencils (port of arkoserenderer_tpu/ops/image.py, the
functions the post chain uses: TAA reprojection, the bloom pyramid, depth of
field, motion blur). All take (H, W, C) images and run as plain tensor ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clamped_index(v: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """trunc(v) + offset clipped to [0, n - 1], as int64. ``v`` is clamped to
    [-2, n + 1] first so the cast never leaves the integer range; the clip
    gives the same index either way."""
    return torch.clamp(torch.clamp(v, -2.0, n + 1.0).to(torch.int64) + offset, 0, n - 1)


def bilinear_sample_many(imgs, x: torch.Tensor, y: torch.Tensor) -> list[torch.Tensor]:
    """``bilinear_sample`` of several (H, W, C_i) images of one size at the
    same coordinates: the tap indices and weights are formed once.

    Fetch images apart rather than concatenated to 4 channels: torch gathers
    rows of 16 bytes with another kernel, which took 1.25 ms for 2.07 M rows
    of 4 floats against 0.05 ms for rows of 3 and 0.07 ms for rows of 5
    (one H100 80GB HBM3, 700 W)."""
    h, w = imgs[0].shape[0], imgs[0].shape[1]
    fx = x - 0.5
    fy = y - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0i = clamped_index(x0, w)
    x1i = clamped_index(x0, w, 1)
    y0w = clamped_index(y0, h) * w
    y1w = clamped_index(y0, h, 1) * w
    i00, i10, i01, i11 = y0w + x0i, y0w + x1i, y1w + x0i, y1w + x1i
    out = []
    for img in imgs:
        flat = img.reshape(-1, img.shape[-1])
        top = flat[i00] * (1 - tx) + flat[i10] * tx
        bot = flat[i01] * (1 - tx) + flat[i11] * tx
        out.append(top * (1 - ty) + bot * ty)
    return out


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (H, W, C) at float pixel coordinates ((N,) x and y, pixel-centre
    based: x = 0.5 is texel 0's centre). Clamp addressing. Returns (N, C)."""
    return bilinear_sample_many((img,), x, y)[0]


def _as_planes(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> a (1, C, H, W) view for the pooling functions."""
    return img.permute(2, 0, 1)[None]


def _from_planes(planes: torch.Tensor) -> torch.Tensor:
    return planes[0].permute(1, 2, 0)


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 box downsample (the block sum times 0.25); H and W even."""
    return _from_planes(F.avg_pool2d(_as_planes(img), 2, stride=2, divisor_override=1)) * 0.25


def shift_img(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped static shift of the first two axes:
    out[y, x] = img[clamp(y + dy), clamp(x + dx)]."""

    def along(a, d, axis):
        if d == 0:
            return a
        n = a.shape[axis]
        edge = a.narrow(axis, 0 if d < 0 else n - 1, 1)
        pad = edge.repeat_interleave(min(abs(d), n), dim=axis)
        keep = a.narrow(axis, 0, max(n - abs(d), 0)) if d < 0 else a.narrow(
            axis, min(d, n), max(n - d, 0))
        return torch.cat([pad, keep] if d < 0 else [keep, pad], dim=axis)

    return along(along(img, dy, 0), dx, 1)


def blur3(img: torch.Tensor) -> torch.Tensor:
    """3x3 binomial ([1, 2, 1] / 4, separable) blur with edge clamp."""

    def conv_axis(x, axis):
        n = x.shape[axis]
        p = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], dim=axis)
        return (0.25 * p.narrow(axis, 0, n) + 0.5 * p.narrow(axis, 1, n)
                + 0.25 * p.narrow(axis, 2, n))

    return conv_axis(conv_axis(img, 0), 1)


def upsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample followed by the 3x3 binomial blur."""
    return blur3(img.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1))


def neighborhood_min_max(img: torch.Tensor):
    """Per-pixel 3x3 min and max; windows are cut at the border (the pooling
    pads with -inf, which never wins), which equals edge clamp."""
    planes = _as_planes(img)
    hi = F.max_pool2d(planes, 3, stride=1, padding=1)
    lo = -F.max_pool2d(-planes, 3, stride=1, padding=1)
    return _from_planes(lo), _from_planes(hi)


def sample_catmull_rom(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """16-tap Catmull-Rom resampling at pixel-centre coordinates (sharper TAA
    history than bilinear). Each tap index is cast to an integer before it is
    clipped, so negative coordinates truncate toward zero first."""
    h, w = img.shape[0], img.shape[1]
    fx = x - 0.5
    fy = y - 0.5
    cx = torch.floor(fx - 0.5) + 0.5  # centre tap
    cy = torch.floor(fy - 0.5) + 0.5
    tx = fx - cx
    ty = fy - cy

    def weights(t):
        t2 = t * t
        t3 = t2 * t
        return (-0.5 * t3 + t2 - 0.5 * t,
                1.5 * t3 - 2.5 * t2 + 1.0,
                -1.5 * t3 + 2.0 * t2 + 0.5 * t,
                0.5 * t3 - 0.5 * t2)

    wx = weights(tx)
    wy = weights(ty)
    flat = img.reshape(-1, img.shape[-1])
    cols = [clamped_index(cx + (i - 1), w) for i in range(4)]
    acc = 0.0
    for j, wyj in enumerate(wy):
        row = clamped_index(cy + (j - 1), h) * w
        for i, wxi in enumerate(wx):
            acc = acc + flat[row + cols[i]] * (wxi * wyj)[:, None]
    return acc


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec. 709 luma of (..., 3) colours, keeping a last axis of 1."""
    return rgb[..., 0:1] * 0.2126 + rgb[..., 1:2] * 0.7152 + rgb[..., 2:3] * 0.0722
