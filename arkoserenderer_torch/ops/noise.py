"""Screen-tiled blue noise (port of arkoserenderer_tpu/ops/noise.py).

A 128x128 void-and-cluster rank mask (assets/data/bluenoise_128.npy, the
reference's committed mask) tiled over the screen; a salt shifts the tile,
and each frame rotates the values by a salt-selected irrational
(Cranley-Patterson), so two salts at one pixel walk an R2 sequence. The
frame index is a host int or, in a frame (``FrameContext.frame_index``), a
0-d integer tensor on the device: the rotation is then formed there, in
float32 as on the host, so both give the same bits. The mask is a device
constant, made once a device.

``mul_u32`` is the uint32 multiply of the reference's integer hashes, on
int64 words (torch has no uint32 arithmetic).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from arkoserenderer_torch.core.constants import device_constant

_N = 128
MASK32 = 0xFFFFFFFF
_ALPHAS = (0.6180339887498949, 0.7548776662466927, 0.5698402909980532)


@functools.lru_cache(maxsize=1)
def blue_noise_ranks() -> np.ndarray:
    """(128, 128) the void-and-cluster mask's ranks, 0 .. N^2 - 1."""
    return np.load(Path(__file__).resolve().parents[1] / "assets" / "data"
                   / "bluenoise_128.npy")


@functools.lru_cache(maxsize=1)
def blue_noise_mask() -> np.ndarray:
    """(128, 128) float32 in (0, 1): (rank + 0.5) / N^2."""
    ranks = blue_noise_ranks().astype(np.float32)
    return (ranks + 0.5) / ranks.size


def sample_blue_noise(px: torch.Tensor, py: torch.Tensor, frame_index,
                      salt: int = 0) -> torch.Tensor:
    """Blue-noise value in [0, 1) per pixel (px, py integer tensors) of
    frame ``frame_index`` (a host int or a 0-d integer tensor)."""
    mask = device_constant("blue noise mask", blue_noise_mask, px.device)
    sx = (salt * 61) % _N
    sy = (salt * 101 + (salt >> 3) * 31) % _N
    x = (px.to(torch.int64) + sx) & (_N - 1)
    y = (py.to(torch.int64) + sy) & (_N - 1)
    v = mask[y, x]
    alpha = float(np.float32(_ALPHAS[salt % 3]))
    if isinstance(frame_index, torch.Tensor):
        t = frame_index.to(torch.float32) * alpha
        return torch.remainder(v + t - torch.floor(t), 1.0)
    t = np.float32(frame_index) * np.float32(alpha)
    return torch.remainder(v + float(t) - float(np.floor(t)), 1.0)


def frame_word(frame_index):
    """The frame index as the reference's integer hashes take it: masked to
    32 bits, an int64 tensor where it is a tensor (its arithmetic then
    stays on the device), else a host int (None is frame 0)."""
    if isinstance(frame_index, torch.Tensor):
        return frame_index.to(torch.int64) & MASK32
    return int(frame_index or 0) & MASK32


def mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for int64 words 0 <= a < 2^32 and a constant c < 2^32,
    in 16-bit halves of c so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32
