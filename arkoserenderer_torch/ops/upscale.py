"""Spatial upscaling and the render-resolution presets (port of
arkoserenderer_tpu/ops/upscale.py): a rational-ratio bilinear resample
followed by contrast-adaptive sharpening. The presets are small exact
ratios (quality 2/3, balanced 3/5, performance 1/2), so the resample is a
few strided slices per phase (``ops/image.resize_bilinear_rational``).
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops.image import resize_bilinear_rational
from arkoserenderer_torch.ops.postprocess import cas

PRESETS = {"quality": (2, 3), "balanced": (3, 5), "performance": (1, 2)}


def upscale(img: torch.Tensor, out_h: int, out_w: int, sharpness: float = 0.4) -> torch.Tensor:
    """(h, w, C) -> (out_h, out_w, C): bilinear resample, clipped to [0, 1],
    then adaptive sharpening when ``sharpness`` > 0."""
    out = torch.clamp(resize_bilinear_rational(img, out_h, out_w), 0.0, 1.0)
    if sharpness > 0.0:
        out = cas(out, sharpness)
    return out


def ideal_render_resolution(display_w: int, display_h: int, quality: str = "quality"):
    """(render width, render height) of a preset: each display size is
    rounded down to a multiple of 8 * den, so the render size is a multiple
    of 8 (raster tiles) at exactly num/den of it."""
    num, den = PRESETS[quality]

    def snap(v):
        return (v // (den * 8)) * (den * 8)

    return snap(display_w) * num // den, snap(display_h) * num // den
