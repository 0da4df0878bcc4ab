"""Shared pieces of the overlay passes (DebugDraw, IconBillboards,
DDGIProbeDebug): projecting world points to pixel columns and rows, and
the colour scatter whose last update wins.

The reference writes its overlays with ``ldr.at[idx].set(colors)``, whose
updates XLA on the CPU applies in order, so where two updates hit one pixel
the later one stays. ``torch.Tensor.index_put_`` on CUDA gives no order.
``scatter_last`` makes the rule explicit: the largest update index wins
each pixel, found with a deterministic ``amax`` scatter of the indices and
then one gather of the colours.
"""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.constants import device_constant

_I32_MIN, _I32_MAX = -2147483648.0, 2147483520.0  # the float32 range of int32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int32)`` as XLA gives it: truncation toward zero, NaN to
    0, values past the int32 range saturated (as int64, so the offsets
    added later cannot wrap)."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), _I32_MIN, _I32_MAX)
    return x.to(torch.int32).to(torch.int64)


def project(view_proj: torch.Tensor, pts: torch.Tensor, width: int, height: int,
            row_offset: int = 0):
    """(xi, yi, depth, in_front) of world points (N, 3): the reference's
    projection to integer pixel coordinates (columns and rows truncated),
    the reverse-Z depth, and w > 1e-4. ``height`` is the whole frame's;
    under pixel-band sharding the rows are the band's, ``row_offset``
    (its first frame row) taken off before the truncation as the
    reference does, so each rank splats only into its own band."""
    clip = mx.transform_points_h(view_proj, pts)
    wc = clip[:, 3]
    ok = wc > 1e-4
    inv_w = torch.where(ok, 1.0 / torch.clamp(wc, min=1e-6), 0.0)
    sx = (clip[:, 0] * inv_w * 0.5 + 0.5) * width
    sy = (0.5 - clip[:, 1] * inv_w * 0.5) * height - row_offset
    return to_i32(sx), to_i32(sy), clip[:, 2] * inv_w, ok


def scatter_last(ldr: torch.Tensor, pixel: torch.Tensor, on: torch.Tensor,
                 colors: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) ``ldr`` with update u writing ``colors[u]`` at flat pixel
    ``pixel[u]`` where ``on[u]``; where several updates hit one pixel, the
    one with the largest u wins (the reference's in-order scatter)."""
    h, w, _ = ldr.shape
    n = h * w
    idx = torch.where(on, pixel, n)
    order = torch.arange(idx.shape[0], device=ldr.device)
    win = torch.full((n + 1,), -1, dtype=torch.int64, device=ldr.device)
    win.scatter_reduce_(0, idx, order, reduce="amax")
    win = win[:n]
    if colors.shape[0] == 0:
        return ldr.clone()
    # Every pixel gathers its winner (a mask's rows would be a readback).
    picked = colors[torch.clamp(win, min=0)].to(ldr.dtype)
    return torch.where((win >= 0)[:, None], picked, ldr.reshape(n, 3)).reshape(h, w, 3)


def disc_offsets(r: int) -> list[tuple[int, int]]:
    """(dy, dx) of the pixels of a filled disc of radius ``r``."""
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if dy * dy + dx * dx <= r * r]


def splat(ldr: torch.Tensor, depth: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
          d: torch.Tensor, ok: torch.Tensor, color: torch.Tensor, offsets, depth_test: bool):
    """Every point's sprite of pixel ``offsets`` over ``ldr``, offset by
    offset as the reference loops (a later offset, then a later point,
    wins a shared pixel); a sprite pixel behind the scene's depth is
    skipped under ``depth_test``."""
    h, w, _ = ldr.shape
    off = device_constant(("sprite offsets", tuple(offsets)),
                          lambda: np.array(offsets, np.int64), ldr.device)  # (K, 2)
    py = yi[None, :] + off[:, 0:1]                                     # (K, P)
    px = xi[None, :] + off[:, 1:2]
    on = ok[None, :] & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    if depth_test:
        scene_d = depth.reshape(-1)[torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)]
        on = on & (d[None, :] >= scene_d)
    k = off.shape[0]
    return scatter_last(ldr, (py * w + px).reshape(-1), on.reshape(-1),
                        color.repeat(k, 1))
