"""Screen-tiled blue noise (port of arkoserenderer_tpu/ops/noise.py).

A 128x128 void-and-cluster rank mask (assets/data/bluenoise_128.npy, the
reference's committed mask) tiled over the screen; a salt shifts the tile,
and each frame rotates the values by a salt-selected irrational
(Cranley-Patterson), so two salts at one pixel walk an R2 sequence.

``mul_u32`` is the uint32 multiply of the reference's integer hashes, on
int64 words (torch has no uint32 arithmetic).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

_N = 128
MASK32 = 0xFFFFFFFF
_ALPHAS = (0.6180339887498949, 0.7548776662466927, 0.5698402909980532)


@functools.lru_cache(maxsize=1)
def blue_noise_mask() -> np.ndarray:
    """(128, 128) float32 in (0, 1): (rank + 0.5) / N^2."""
    ranks = np.load(Path(__file__).resolve().parents[1] / "assets" / "data"
                    / "bluenoise_128.npy").astype(np.float32)
    return (ranks + 0.5) / ranks.size


def sample_blue_noise(px: torch.Tensor, py: torch.Tensor, frame_index: int,
                      salt: int = 0) -> torch.Tensor:
    """Blue-noise value in [0, 1) per pixel (px, py integer tensors)."""
    mask = torch.from_numpy(blue_noise_mask()).to(px.device)
    sx = (salt * 61) % _N
    sy = (salt * 101 + (salt >> 3) * 31) % _N
    x = (px.to(torch.int64) + sx) & (_N - 1)
    y = (py.to(torch.int64) + sy) & (_N - 1)
    v = mask[y, x]
    t = np.float32(frame_index) * np.float32(_ALPHAS[salt % 3])
    return torch.remainder(v + float(t) - float(np.floor(t)), 1.0)


def mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for int64 words 0 <= a < 2^32 and a constant c < 2^32,
    in 16-bit halves of c so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32
