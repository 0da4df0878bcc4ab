"""Meshlet building and BC4/BC5 block compression (port of
arkoserenderer_tpu/assets/meshopt.py: ``build_meshlets`` with its NumPy
greedy scan, and the NumPy ``compress_bc4``, ``decompress_bc4`` and
``compress_bc5``).

The reference also builds these as a native g++ library, which it runs
where g++ is found; the port gives the native library's blocks in numpy
and needs no native code:
meshlets are built once per segment at scene build, and BC4/BC5 blocks are
coded once per image at asset preparation or load.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Meshlets:
    """Per-meshlet triangle ranges and culling bounds."""

    tri_offset: np.ndarray  # (M,) into the segment's triangle list
    tri_count: np.ndarray   # (M,)
    sphere: np.ndarray      # (M, 4) centre xyz + radius
    cone: np.ndarray        # (M, 4) axis xyz + cutoff (min dot of a face normal with the axis)

    @property
    def count(self) -> int:
        return len(self.tri_offset)


def build_meshlets(positions: np.ndarray, indices: np.ndarray,
                   max_verts: int = 64, max_tris: int = 126) -> Meshlets:
    """Greedy meshlet scan in triangle order: a meshlet takes triangles
    until one more would exceed ``max_verts`` distinct vertices or
    ``max_tris`` triangles. Its sphere is centred on the mean of its
    triangle centroids; its cone axis is the normalised sum of its unit
    face normals, and the cutoff the least dot of a face normal with it."""
    tris = np.ascontiguousarray(indices.reshape(-1, 3), np.int32)
    pos = np.ascontiguousarray(positions, np.float32)
    t = len(tris)
    if t == 0:
        z = np.zeros((0,), np.int32)
        return Meshlets(z, z, np.zeros((0, 4), np.float32), np.zeros((0, 4), np.float32))

    offs, cnts, spheres, cones = [], [], [], []
    cursor = 0
    while cursor < t:
        start = cursor
        verts: set[int] = set()
        while cursor < t and cursor - start < max_tris:
            tri_set = set(tris[cursor])
            if len(verts | tri_set) > max_verts:
                break
            verts |= tri_set
            cursor += 1
        if cursor == start:
            cursor += 1
        seg = tris[start:cursor]
        pts = pos[seg.reshape(-1)]
        center = pos[seg].mean(axis=1).mean(axis=0)
        radius = np.linalg.norm(pts - center, axis=-1).max()
        e1 = pos[seg[:, 1]] - pos[seg[:, 0]]
        e2 = pos[seg[:, 2]] - pos[seg[:, 0]]
        fn = np.cross(e1, e2)
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        ok = ln[:, 0] > 1e-20
        fn = np.where(ok[:, None], fn / np.maximum(ln, 1e-20), 0.0)
        axis_v = fn.sum(0)
        al = np.linalg.norm(axis_v)
        if al > 1e-12:
            axis_v = axis_v / al
            cutoff = float(np.min(fn[ok] @ axis_v)) if ok.any() else 1.0
        else:
            axis_v = np.array([0, 0, 1.0], np.float32)
            cutoff = 1.0
        offs.append(start)
        cnts.append(cursor - start)
        spheres.append([*center, radius])
        cones.append([*axis_v, cutoff])
    return Meshlets(
        np.array(offs, np.int32), np.array(cnts, np.int32),
        np.array(spheres, np.float32), np.array(cones, np.float32),
    )


def decompress_bc4(blocks: np.ndarray, height: int, width: int) -> np.ndarray:
    """(nblocks, 8) uint8 BC4 blocks -> (height, width) uint8: two
    endpoints and 3-bit indices into the 8-entry palette (6 interpolated
    entries when e0 > e1, else 4 and the constants 0 and 255)."""
    blk = np.ascontiguousarray(blocks.reshape(-1), np.uint8).reshape(-1, 8)
    e0 = blk[:, 0].astype(np.int32)
    e1 = blk[:, 1].astype(np.int32)
    pal = np.zeros((len(blk), 8), np.int32)
    pal[:, 0] = e0
    pal[:, 1] = e1
    for i in range(1, 7):
        interp = ((7 - i) * e0 + i * e1) // 7
        alt = ((5 - i) * e0 + i * e1) // 5 if i < 5 else (0 if i == 5 else 255)
        pal[:, 1 + i] = np.where(e0 > e1, interp, alt)
    bits = np.zeros(len(blk), np.uint64)
    for i in range(6):
        bits |= blk[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    texels = np.zeros((len(blk), 16), np.uint8)
    for i in range(16):
        code = ((bits >> np.uint64(3 * i)) & np.uint64(7)).astype(np.int64)
        texels[:, i] = pal[np.arange(len(blk)), code]
    bh, bw = height // 4, width // 4
    return texels.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(height, width)


def compress_bc4(channel: np.ndarray) -> np.ndarray:
    """(H, W) uint8 (H and W multiples of 4) -> (H/4 * W/4, 8) uint8 BC4
    blocks in row-major block order: e0 = the block's max, e1 = its min
    (the six-interpolant palette), each texel's index its position between
    them, (v - min) / (max - min) * 7 in float64 rounded half away from
    zero, as the reference's native encoder rounds (its NumPy fallback
    rounds half to even, and differs at exact ties); 0 for a flat block."""
    h, w = channel.shape
    if h % 4 or w % 4:
        raise ValueError(f"BC4 needs sides that are multiples of 4, not {h}x{w}")
    channel = np.ascontiguousarray(channel, np.uint8)
    blocks = channel.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
    mn = blocks.min(1).astype(np.int32)
    mx = blocks.max(1).astype(np.int32)
    out = np.zeros((len(blocks), 8), np.uint8)
    out[:, 0] = mx
    out[:, 1] = mn
    span = np.maximum(mx - mn, 1)[:, None].astype(np.float64)
    pos = (blocks.astype(np.int32) - mn[:, None]) / span * 7.0
    whole = np.floor(pos)
    tq = (whole + (pos - whole >= 0.5)).astype(np.int32)
    # Position 0 (the min) is palette entry 1, 7 (the max) entry 0, and
    # position i in between entry 8 - i.
    remap = np.array([1, 7, 6, 5, 4, 3, 2, 0], np.int64)
    codes = np.where((mx == mn)[:, None], 0, remap[np.clip(tq, 0, 7)])
    bits = np.zeros(len(blocks), np.uint64)
    for i in range(16):
        bits |= codes[:, i].astype(np.uint64) << np.uint64(3 * i)
    for i in range(6):
        out[:, 2 + i] = (bits >> np.uint64(8 * i)).astype(np.uint8)
    return out


def compress_bc5(r: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Two-channel BC5 (normal maps): (H, W) + (H, W) uint8 -> (blocks, 16),
    each block the BC4 block of ``r`` then that of ``g``."""
    return np.concatenate([compress_bc4(r), compress_bc4(g)], axis=1)
