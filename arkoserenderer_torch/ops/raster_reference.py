"""The per-pixel numpy rasterizer, the raster's oracle (port of
arkoserenderer_tpu/ops/raster_reference.py).

Every triangle against every pixel centre, O(pixels x triangles), with the
tile raster's edge functions and conventions: coverage equal to
``ops/raster.rasterize``'s, depth close to it. Tests and ``chip_smoke.py``
hold the raster to it; no frame calls it.
"""

from __future__ import annotations

import numpy as np

from arkoserenderer_torch.core.types import VIS_NONE


def rasterize_numpy(
    clip: np.ndarray,
    indices: np.ndarray,
    tri_valid: np.ndarray,
    width: int,
    height: int,
    cull_backfaces: bool = True,
    w_eps: float = 1e-6,
):
    """(V, 4) clip-space vertices through (T, 3) indices -> (vis (H, W)
    i32 triangle ids, depth (H, W) f32 reverse-Z, 0 far). Triangles with a
    corner at w <= ``w_eps`` are skipped (no near clipping); the
    earlier triangle wins a depth tie."""
    vis = np.full((height, width), VIS_NONE, dtype=np.int32)
    depth = np.zeros((height, width), dtype=np.float32)

    xs = np.arange(width, dtype=np.float32) + 0.5
    ys = np.arange(height, dtype=np.float32) + 0.5
    px, py = np.meshgrid(xs, ys)

    def edge(a, b, qx, qy):
        return (b[1] - a[1]) * (qx - a[0]) - (b[0] - a[0]) * (qy - a[1])

    for t in range(indices.shape[0]):
        if not tri_valid[t]:
            continue
        tri = clip[indices[t]]  # (3, 4)
        w = tri[:, 3]
        if np.any(w <= w_eps):
            continue
        ndc = tri[:, :3] / w[:, None]
        sx = (ndc[:, 0] * 0.5 + 0.5) * width
        sy = (0.5 - ndc[:, 1] * 0.5) * height
        s = np.stack([sx, sy], axis=-1)

        area2 = edge(s[0], s[1], s[2, 0], s[2, 1])
        if cull_backfaces:
            if area2 <= 1e-12:
                continue
        elif abs(area2) <= 1e-12:
            continue

        e0 = edge(s[1], s[2], px, py)
        e1 = edge(s[2], s[0], px, py)
        e2 = edge(s[0], s[1], px, py)
        l0, l1, l2 = e0 / area2, e1 / area2, e2 / area2
        d = l0 * ndc[0, 2] + l1 * ndc[1, 2] + l2 * ndc[2, 2]
        covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (d > depth)
        vis[covered] = t
        depth[covered] = d[covered]
    return vis, depth
