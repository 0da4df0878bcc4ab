"""Display mapping: tonemap operators, the PQ encode, vignette and film
grain (port of arkoserenderer_tpu/ops/tonemap.py). All operators are
elementwise on (..., 3) linear RGB.

  * ACES: Stephen Hill's RRT+ODT fit.
  * AgX: the minimal AgX approximation (Wrensch / Sobotka).
  * Khronos PBR Neutral: the published Khronos spec.
"""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.ops.noise import sample_blue_noise
from arkoserenderer_torch.ops.texture import linear_to_srgb  # noqa: F401 (re-export)

TONEMAP_CLAMP = 0
TONEMAP_REINHARD = 1
TONEMAP_ACES = 2
TONEMAP_AGX = 3
TONEMAP_KHRONOS_PBR_NEUTRAL = 4

MODES = {
    "clamp": TONEMAP_CLAMP,
    "reinhard": TONEMAP_REINHARD,
    "aces": TONEMAP_ACES,
    "agx": TONEMAP_AGX,
    "khronos_pbr_neutral": TONEMAP_KHRONOS_PBR_NEUTRAL,
}


def tonemap_clamp(c):
    return torch.clamp(c, 0.0, 1.0)


def tonemap_reinhard(c):
    return c / (1.0 + c)


_ACES_IN = np.array(
    [[0.59719, 0.35458, 0.04823],
     [0.07600, 0.90834, 0.01566],
     [0.02840, 0.13383, 0.83777]], np.float32)
_ACES_OUT = np.array(
    [[1.60475, -0.53108, -0.07367],
     [-0.10208, 1.10813, -0.00605],
     [-0.00327, -0.07276, 1.07602]], np.float32)


def _mat3_ew(m, c):
    """(3,3) constant matrix applied to (..., 3) as broadcast mul-adds."""
    return torch.stack(
        [c[..., 0] * float(m[r][0]) + c[..., 1] * float(m[r][1]) + c[..., 2] * float(m[r][2])
         for r in range(3)],
        dim=-1,
    )


def tonemap_aces(c):
    v = _mat3_ew(_ACES_IN, c)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return torch.clamp(_mat3_ew(_ACES_OUT, a / b), 0.0, 1.0)


_AGX_IN = np.array(
    [[0.842479062253094, 0.0423282422610123, 0.0423756549057051],
     [0.0784335999999992, 0.878468636469772, 0.0784336],
     [0.0792237451477643, 0.0791661274605434, 0.879142973793104]], np.float32)
_AGX_OUT = np.array(
    [[1.19687900512017, -0.0528968517574562, -0.0529716355144438],
     [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
     [-0.0990297440797205, -0.0989611768448433, 1.15107367264116]], np.float32)
_AGX_MIN_EV = -12.47393
_AGX_MAX_EV = 4.026069


def _agx_default_contrast(x):
    """6th-order polynomial fit of the AgX sigmoid contrast curve."""
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


def tonemap_agx(c):
    v = _mat3_ew(_AGX_IN, c)
    v = torch.clamp(torch.log2(torch.clamp(v, min=1e-10)), _AGX_MIN_EV, _AGX_MAX_EV)
    v = (v - _AGX_MIN_EV) / (_AGX_MAX_EV - _AGX_MIN_EV)
    v = _agx_default_contrast(v)
    v = torch.clamp(_mat3_ew(_AGX_OUT, v), 0.0, 1.0)
    # The sigmoid outputs display-encoded values; back to linear so the
    # output stage applies the transfer function once.
    return torch.pow(v, 2.2)


def tonemap_khronos_pbr_neutral(c):
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = torch.amin(c, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = c - offset
    peak = torch.amax(c, dim=-1, keepdim=True)
    new_peak = 1.0 - (1.0 - start_compression) ** 2 / (peak + 1.0 - 2.0 * start_compression)
    scaled = c * (new_peak / torch.clamp(peak, min=1e-6))
    g = 1.0 / (desaturation * (peak - new_peak) + 1.0)
    out = g * scaled + (1.0 - g) * new_peak
    return torch.where(peak > start_compression, out, c)


_TONEMAP_FNS = {
    TONEMAP_CLAMP: tonemap_clamp,
    TONEMAP_REINHARD: tonemap_reinhard,
    TONEMAP_ACES: tonemap_aces,
    TONEMAP_AGX: tonemap_agx,
    TONEMAP_KHRONOS_PBR_NEUTRAL: tonemap_khronos_pbr_neutral,
}


def tonemap(c, mode: int):
    return _TONEMAP_FNS[mode](c)


def encode_st2084(c_nits: torch.Tensor) -> torch.Tensor:
    """PQ / SMPTE ST 2084 inverse EOTF of absolute nits (clipped to 10,000)."""
    m1 = 2610.0 / 16384.0
    m2 = 2523.0 / 4096.0 * 128.0
    c1 = 3424.0 / 4096.0
    c2 = 2413.0 / 4096.0 * 32.0
    c3 = 2392.0 / 4096.0 * 32.0
    y = torch.clamp(c_nits / 10000.0, 0.0, 1.0)
    yp = torch.pow(y, m1)
    return torch.pow((c1 + c2 * yp) / (1.0 + c3 * yp), m2)


def vignette(color, uv, intensity: float):
    """Natural-ish vignette; uv in [0,1]^2, intensity 0 disables."""
    d = uv - 0.5
    r2 = torch.sum(d * d, dim=-1, keepdim=True) * 4.0
    falloff = 1.0 - intensity * r2 * r2
    return color * torch.clamp(falloff, 0.0, 1.0)


def film_grain(color, pixel_xy, frame_index: int, gain: float):
    """ISO-scaled additive blue-noise grain, animated per frame."""
    px = pixel_xy[..., 0].to(torch.int32)
    py = pixel_xy[..., 1].to(torch.int32)
    g = (sample_blue_noise(px, py, frame_index, salt=7)[..., None] - 0.5) * gain
    return torch.clamp(color + g * torch.sqrt(torch.clamp(color, min=1e-4)), min=0.0)
