"""The RGBA8 bindless texture pool and its filtered sampling (port of
arkoserenderer_tpu/ops/texture.py: ``TexturePool``, ``generate_mip_chain``,
``pack_rgba8``, ``TexturePoolBuilder``, ``unpack_rgba8``,
``srgb_to_linear``, ``linear_to_srgb``, ``_fetch_bilinear`` and
``sample_trilinear``).

Every mip of every texture lives in one flat pool of packed RGBA8 texels
(r | g << 8 | b << 16 | a << 24), addressed as

    texel = mip_offset[texture, level] + y * mip_width + x

so one gather serves any texture and mip. The mips of an sRGB texture are
averaged in linear space (decoded before the 2x2 box filter, encoded
after); the sampler decodes sRGB texels to linear before it filters. The
path tracer samples this pool. It is not the channel-packed pool of the
raster's shading (``ops/mattex``), whose mips average the encoded values.

The pool is built on the host in numpy, as the reference builds it, and
moved to the device once (``Scene.build``). On the device the texels are
int32 with the uint32's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_MIPS = 13  # up to 4096x4096
WRAP_REPEAT = 0
WRAP_CLAMP = 1
# Default textures at ids 0-3: white, black, flat normal, mid-gray.
DEFAULT_TEXTURES = ([255, 255, 255, 255], [0, 0, 0, 255], [128, 128, 255, 255],
                    [128, 128, 128, 255])


class TexturePool(NamedTuple):
    """The pool on the device (fixed capacity)."""

    texels: torch.Tensor      # (pool_size,) i32: packed RGBA8, the uint32's bits
    mip_offset: torch.Tensor  # (max_tex, MAX_MIPS) i32 texel offset of each mip
    mip_size: torch.Tensor    # (max_tex, MAX_MIPS, 2) i32 (width, height), >= 1
    n_mips: torch.Tensor      # (max_tex,) i32
    srgb: torch.Tensor        # (max_tex,) bool: decode to linear when sampling
    wrap: torch.Tensor        # (max_tex,) i32: WRAP_REPEAT or WRAP_CLAMP


# ---------------------------------------------------------------------------
# Host-side pool building


def _srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.maximum(c, 0.0) ** (1 / 2.4) - 0.055)


def generate_mip_chain(img: np.ndarray, *, srgb: bool = False) -> list[np.ndarray]:
    """2x2 box-filter mip chain of an (H, W, 4) uint8 image. An sRGB
    texture's RGB is decoded to linear before averaging and encoded after
    (alpha is linear); other data filters raw."""
    mips = [img]
    cur = img.astype(np.float32)
    if srgb:
        cur[..., :3] = _srgb_to_linear_np(cur[..., :3] / 255.0)
        cur[..., 3] /= 255.0
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h = max(cur.shape[0] // 2, 1)
        w = max(cur.shape[1] // 2, 1)
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = cur.reshape(h, 2, w, 2, 4).mean(axis=(1, 3))
        elif cur.shape[0] > 1:
            cur = cur.reshape(h, 2, 1, 4).mean(axis=1)
        else:
            cur = cur.reshape(1, w, 2, 4).mean(axis=2)
        if srgb:
            enc = np.concatenate([_linear_to_srgb_np(cur[..., :3]), cur[..., 3:]], axis=-1) * 255.0
        else:
            enc = cur
        mips.append(np.clip(enc + 0.5, 0, 255).astype(np.uint8))
    return mips


def pack_rgba8(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (H*W,) uint32."""
    img = img.astype(np.uint32)
    return (img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)
            | (img[..., 3] << 24)).reshape(-1)


class TexturePoolBuilder:
    """Accumulates textures on the host; ``host_fields`` freezes them to the
    pool's arrays. The four default textures take ids 0-3."""

    def __init__(self, max_textures: int, pool_capacity: int):
        self.max_textures = max_textures
        self.pool_capacity = pool_capacity
        self._texels: list[np.ndarray] = []
        self._offset = np.zeros((max_textures, MAX_MIPS), np.int32)
        self._size = np.ones((max_textures, MAX_MIPS, 2), np.int32)
        self._n_mips = np.zeros((max_textures,), np.int32)
        self._srgb = np.zeros((max_textures,), bool)
        self._wrap = np.zeros((max_textures,), np.int32)
        self._cursor = 0
        self.images: list[tuple[np.ndarray, bool, int]] = []  # (img RGBA8, srgb, wrap)
        for rgba in DEFAULT_TEXTURES:
            self.add(np.full((1, 1, 4), rgba, np.uint8), srgb=False, mipmapped=False)

    def add(self, img: np.ndarray, *, srgb: bool, wrap: int = WRAP_REPEAT,
            mipmapped: bool = True) -> int:
        """Add an (H, W, C<=4) uint8 image (alpha opaque where absent);
        returns its bindless texture id."""
        tid = len(self.images)
        if tid >= self.max_textures:
            raise ValueError("texture id capacity exceeded")
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] < 4:
            pad = np.zeros(img.shape[:2] + (4 - img.shape[2],), np.uint8)
            pad[..., -1] = 255
            img = np.concatenate([img, pad], axis=-1)
        mips = (generate_mip_chain(img, srgb=srgb) if mipmapped else [img])[:MAX_MIPS]
        for level, m in enumerate(mips):
            n = m.shape[0] * m.shape[1]
            if self._cursor + n > self.pool_capacity:
                raise ValueError("texel pool capacity exceeded")
            self._offset[tid, level] = self._cursor
            self._size[tid, level] = (m.shape[1], m.shape[0])
            self._texels.append(pack_rgba8(m))
            self._cursor += n
        # Unused mip slots repeat the last mip, so a clamped LOD stays in bounds.
        self._offset[tid, len(mips):] = self._offset[tid, len(mips) - 1]
        self._size[tid, len(mips):] = self._size[tid, len(mips) - 1]
        self._n_mips[tid] = len(mips)
        self._srgb[tid] = srgb
        self._wrap[tid] = wrap
        self.images.append((img, srgb, wrap))
        return tid

    def host_fields(self) -> dict[str, np.ndarray]:
        """The pool's arrays by TexturePool field name, texels padded to the
        capacity."""
        texels = np.zeros((self.pool_capacity,), np.uint32)
        if self._texels:
            data = np.concatenate(self._texels)
            texels[: data.shape[0]] = data
        return {"texels": texels, "mip_offset": self._offset.copy(),
                "mip_size": self._size.copy(), "n_mips": self._n_mips.copy(),
                "srgb": self._srgb.copy(), "wrap": self._wrap.copy()}


# ---------------------------------------------------------------------------
# Sampling on the device


def unpack_rgba8(texel: torch.Tensor) -> torch.Tensor:
    """(...,) packed texels (int32 or int64 holding the uint32's bits) ->
    (..., 4) float32 in [0, 1]."""
    chans = [((texel >> s) & 0xFF).to(torch.float32) for s in (0, 8, 16, 24)]
    return torch.stack(chans, dim=-1) * (1.0 / 255.0)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 EOTF."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 inverse EOTF (negative inputs clamp to 0)."""
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def _fetch_bilinear(pool: TexturePool, tex_id, level, uv, decode_srgb: bool,
                    pow2: bool = False) -> torch.Tensor:
    """Bilinear fetch at integer mip ``level``: (N,) ids and levels, (N, 2)
    uv -> (N, 4). ``pow2``: every texture side in the pool is a power of
    two, so REPEAT addressing is a mask."""
    tex_id = tex_id.long()
    level = torch.clamp(level, 0, MAX_MIPS - 1).long()
    off = pool.mip_offset[tex_id, level].long()
    size = pool.mip_size[tex_id, level].long()
    w = size[:, 0].to(torch.float32)
    h = size[:, 1].to(torch.float32)
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    repeat = pool.wrap[tex_id] == WRAP_REPEAT

    def addr(c, extent):
        rep = (c & (extent - 1)) if pow2 else torch.remainder(c, extent)
        return torch.where(repeat, rep, torch.clamp(torch.minimum(c, extent - 1), min=0))

    wi, hi = size[:, 0], size[:, 1]
    x0i = x0.to(torch.int32).long()
    y0i = y0.to(torch.int32).long()
    xs = addr(x0i, wi), addr(x0i + 1, wi)
    ys = addr(y0i, hi), addr(y0i + 1, hi)
    srgb = pool.srgb[tex_id][:, None] if decode_srgb else None

    def texel(xi, yi):
        c = unpack_rgba8(pool.texels[off + yi * wi + xi])
        if srgb is not None:
            rgb = torch.where(srgb, srgb_to_linear(c[:, :3]), c[:, :3])
            c = torch.cat([rgb, c[:, 3:4]], dim=-1)
        return c

    top = texel(xs[0], ys[0]) * (1 - fx) + texel(xs[1], ys[0]) * fx
    bot = texel(xs[0], ys[1]) * (1 - fx) + texel(xs[1], ys[1]) * fx
    return top * (1 - fy) + bot * fy


def sample_trilinear(pool: TexturePool, tex_id: torch.Tensor, uv: torch.Tensor,
                     lod: torch.Tensor | None = None, decode_srgb: bool = True,
                     pow2: bool = False) -> torch.Tensor:
    """(N,) texture ids, (N, 2) uv and (N,) LOD (0 when None) -> (N, 4)
    linear-space RGBA: two bilinear fetches at the LOD's neighbouring mips,
    blended."""
    if lod is None:
        lod = torch.zeros(tex_id.shape, dtype=torch.float32, device=uv.device)
    max_lod = (pool.n_mips[tex_id.long()] - 1).to(torch.float32)
    lod = torch.minimum(torch.maximum(lod, torch.zeros_like(lod)), max_lod)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.minimum(l0 + 1, max_lod.to(torch.int32))
    f = (lod - l0.to(torch.float32))[:, None]
    c0 = _fetch_bilinear(pool, tex_id, l0, uv, decode_srgb, pow2=pow2)
    c1 = _fetch_bilinear(pool, tex_id, l1, uv, decode_srgb, pow2=pow2)
    return c0 * (1 - f) + c1 * f
