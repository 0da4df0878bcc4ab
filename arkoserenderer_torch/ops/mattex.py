"""Channel-packed per-material textures (port of
arkoserenderer_tpu/ops/mattex.py).

Host half: every material's texture slots (base, normal, metallic-roughness,
emissive, occlusion) are resampled to one power-of-two size, box-filtered
into a mip chain and packed per texel into one row of three 32-bit words:

    row = [ base RGBA8 | nx ny rough metal | em.r em.g em.b occl ]

The mips are averaged in gamma space, exactly as the reference builds them
(its ops/mattex.py ``_mip_chain``), so both packages hold the same rows.

The device pool is ``torch.int32``: torch has almost no uint32 arithmetic,
and ``(x >> s) & 0xFF`` recovers every byte exactly despite the sign
extension of the top one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.core.constants import device_constant

MAX_MIPS = 13  # up to 4096^2 per packed material texture

# Packed-material metadata lanes (stored in the material record).
META_LANES = 4 + MAX_MIPS  # wrap, w0, h0, n_mips, offsets[13]


class PackedTexturePool(NamedTuple):
    rows: torch.Tensor  # (capacity, 3) int32 texel rows [base, nrm_mr, em_occ]


def _np_resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Host bilinear resize of (H0, W0, C) -> (h, w, C) float32."""
    img = img.astype(np.float32)
    h0, w0 = img.shape[:2]
    if (h0, w0) == (h, w):
        return img
    x = (np.arange(w) + 0.5) * (w0 / w) - 0.5
    y = (np.arange(h) + 0.5) * (h0 / h) - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w0 - 1)
    x1 = np.clip(x0 + 1, 0, w0 - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h0 - 1)
    y1 = np.clip(y0 + 1, 0, h0 - 1)
    fx = np.clip(x - x0, 0.0, 1.0)[None, :, None]
    fy = np.clip(y - y0, 0.0, 1.0)[:, None, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def _pow2_dims(w: int, h: int, cap: int = 2048) -> tuple[int, int]:
    def up(v):
        p = 1
        while p < v:
            p <<= 1
        return min(p, cap)

    return up(max(w, 1)), up(max(h, 1))


def _mip_chain(planes: np.ndarray) -> list[np.ndarray]:
    """(H, W, C) float32 -> list of mips (2x2 box filter in gamma space)."""
    mips = [planes]
    cur = planes
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h = max(cur.shape[0] // 2, 1)
        w = max(cur.shape[1] // 2, 1)
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = cur.reshape(h, 2, w, 2, cur.shape[2]).mean(axis=(1, 3))
        elif cur.shape[0] > 1:
            cur = cur.reshape(h, 2, 1, cur.shape[2]).mean(axis=1)
        else:
            cur = cur.reshape(1, w, 2, cur.shape[2]).mean(axis=2)
        mips.append(cur)
    return mips[:MAX_MIPS]


def _pack_rows(p12: np.ndarray) -> np.ndarray:
    """(H, W, 12) float [0,255] -> (H*W, 3) uint32."""
    b = np.clip(p12 + 0.5, 0, 255).astype(np.uint32).reshape(-1, 3, 4)
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24))


def _material_key(m) -> tuple:
    return (
        int(m.base_color_tex), int(m.normal_tex), int(m.mr_tex),
        int(m.emissive_tex), int(m.occlusion_tex),
    )


def pack_material_chain(m, images, cursor: int, wrap_default: int = 0):
    """Pack one material's texture chain starting at texel row ``cursor``.

    ``images``: (img_rgba8, srgb, wrap) per bindless texture id; ids 0-3
    are the defaults and mean "slot unused".
    Returns (rows (R, 3) uint32, meta_row (META_LANES,) f32, new_cursor).
    """
    key = _material_key(m)

    def img_of(tid, default_rgba):
        if 0 <= tid < len(images) and tid not in (0, 1, 2, 3):
            return images[tid][0]
        return np.array([[default_rgba]], np.uint8)

    base = img_of(key[0], [255, 255, 255, 255])
    nrm = img_of(key[1], [128, 128, 255, 255])
    mr = img_of(key[2], [255, 255, 255, 255])
    em = img_of(key[3], [255, 255, 255, 255])
    occ = img_of(key[4], [255, 255, 255, 255])

    w = max(i.shape[1] for i in (base, nrm, mr, em, occ))
    h = max(i.shape[0] for i in (base, nrm, mr, em, occ))
    w, h = _pow2_dims(w, h)
    wrap = (
        images[key[0]][2]
        if 0 <= key[0] < len(images) and key[0] > 3
        else wrap_default
    )

    b = _np_resize_bilinear(base, w, h)
    n = _np_resize_bilinear(nrm, w, h)
    r = _np_resize_bilinear(mr, w, h)
    e = _np_resize_bilinear(em, w, h)
    o = _np_resize_bilinear(occ, w, h)
    p12 = np.concatenate(
        [
            b[..., :4],
            n[..., 0:1], n[..., 1:2], r[..., 1:2], r[..., 2:3],
            e[..., 0:1], e[..., 1:2], e[..., 2:3], o[..., 0:1],
        ],
        axis=-1,
    )
    mips = _mip_chain(p12)
    offsets = np.zeros((MAX_MIPS,), np.int64)
    rows_list = []
    for li, mp in enumerate(mips):
        offsets[li] = cursor
        rows_list.append(_pack_rows(mp))
        cursor += mp.shape[0] * mp.shape[1]
    for li in range(len(mips), MAX_MIPS):
        offsets[li] = offsets[len(mips) - 1]
    meta_row = np.zeros((META_LANES,), np.float32)
    meta_row[0] = wrap
    meta_row[1] = w
    meta_row[2] = h
    meta_row[3] = len(mips)
    meta_row[4:] = offsets.astype(np.float32)
    return np.concatenate(rows_list, axis=0), meta_row, cursor


def build_packed_materials(materials, images, wrap_default: int = 0):
    """Host packing of every material's texture slots; materials with the
    same texture-id tuple share one chain.

    Returns (rows (R, 3) uint32, meta (M, META_LANES) float32)."""
    rows_list: list[np.ndarray] = []
    cursor = 0
    cache: dict[tuple, np.ndarray] = {}
    meta = np.zeros((len(materials), META_LANES), np.float32)
    for mi, m in enumerate(materials):
        key = _material_key(m)
        if key not in cache:
            rows, meta_row, cursor = pack_material_chain(m, images, cursor, wrap_default)
            rows_list.append(rows)
            cache[key] = meta_row
        meta[mi] = cache[key]
    if cursor >= (1 << 24):
        raise ValueError("packed texel pool exceeds exact-f32 addressing")
    rows = np.concatenate(rows_list, axis=0) if rows_list else np.zeros((1, 3), np.uint32)
    pad = (-rows.shape[0]) % 8
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, 3), np.uint32)], axis=0)
    return rows, meta


# ---------------------------------------------------------------------------
# Device-side sampling


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _select13(vals: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """vals (N, 13), level (N,) int -> (N,) the lane at ``level`` (lane 0
    where level is outside 1..12, as in the reference)."""
    out = vals[:, 0]
    for lv in range(1, MAX_MIPS):
        out = torch.where(level == lv, vals[:, lv], out)
    return out


def _mip_dim(base: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """max(base >> level, 1) as a select chain (``base`` where level is 0
    or out of range)."""
    out = base
    for lv in range(1, MAX_MIPS):
        out = torch.where(level == lv, torch.clamp(base >> lv, min=1), out)
    return out


_SRGB_LANES = (0, 1, 2, 8, 9, 10)  # base.rgb and emissive.rgb


def _unpack12(rows: torch.Tensor) -> torch.Tensor:
    """(N, 3) int32 -> (N, 12) f32 in [0, 1]; base.rgb and emissive.rgb
    sRGB-decoded, everything else linear."""
    lanes = [
        ((rows[:, c] >> s) & 0xFF).to(torch.float32) * (1.0 / 255.0)
        for c in range(3)
        for s in (0, 8, 16, 24)
    ]
    b = torch.stack(lanes, dim=-1)
    mask = device_constant("srgb lanes", lambda: np.isin(np.arange(12), _SRGB_LANES),
                           rows.device)
    return torch.where(mask[None, :], _srgb_to_linear(b), b)


class MaterialSample(NamedTuple):
    base: torch.Tensor         # (N, 4) linear base color + alpha
    normal_ts: torch.Tensor    # (N, 3) tangent-space normal
    rough_metal: torch.Tensor  # (N, 2)
    emissive: torch.Tensor     # (N, 3) linear
    occlusion: torch.Tensor    # (N,)


def _fetch_level(rows, off, wrap, wl, hl, uv):
    """One bilinear fetch at one mip level per pixel: 4 row gathers."""
    x = uv[:, 0] * wl.to(torch.float32) - 0.5
    y = uv[:, 1] * hl.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    last = rows.shape[0] - 1

    def addr(c, extent):
        rep = c & (extent - 1)  # packed dims are powers of two
        clp = torch.minimum(torch.clamp(c, min=0), extent - 1)
        return torch.where(wrap == 0, rep, clp)

    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            xi = addr(x0i + dx, wl)
            yi = addr(y0i + dy, hl)
            # Clamped like the reference's gather (only uncovered pixels,
            # whose values are discarded, can index out of range).
            idx = torch.clamp(off + yi * wl + xi, 0, last)
            c = _unpack12(rows[idx.long()])
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            out = c * wgt if out is None else out + c * wgt
    return out


def sample_packed(
    rows: torch.Tensor,     # (R, 3) int32 pool
    meta: torch.Tensor,     # (N, META_LANES) per-pixel material texture meta
    uv: torch.Tensor,       # (N, 2)
    duv_dx: torch.Tensor,
    duv_dy: torch.Tensor,
    lod_bias: float = 0.0,  # negative when rendering below display resolution
    quality: str = "trilinear",
    noise: torch.Tensor | None = None,  # (N,) or (N, 3) in [0, 1): the stochastic draws
) -> MaterialSample:
    """Gradient-correct packed material sample; ``lod_bias`` is added to the
    mip level before the clamp. ``quality``:

      * "trilinear" (8 row gathers; "auto" and "sorted" resolve to it);
      * "bilinear": the nearest mip, 4 row gathers (the ray-hit shading's);
      * "anisoN" (N from the name, 4 when it has none): N bilinear taps
        marched along the major gradient axis, each trilinear at the mip of
        the minor axis (clamped to major / N);
      * "stochastic": bilinear at a jittered mip, round(lod + u - 0.5), whose
        expectation is trilinear (``noise`` (N,), or lane 0 of (N, 3));
      * "stochastic1": one texel, from the jittered mip (lane 0) and a
        jittered nearest texel within the bilinear footprint (lanes 1-2:
        round(x + u - 0.5) per axis); ``noise`` (N, 3).

    The stochastic qualities fall back to bilinear without their noise, as
    the reference's do."""
    if quality in ("auto", "sorted"):
        quality = "trilinear"
    aniso = quality.startswith("aniso")
    if not aniso and quality not in ("trilinear", "bilinear", "stochastic", "stochastic1"):
        raise ValueError(f"unknown texture quality {quality!r}")
    wrap = meta[:, 0].to(torch.int32)
    w0 = meta[:, 1].to(torch.int32)
    h0 = meta[:, 2].to(torch.int32)
    n_mips = meta[:, 3]
    offs = meta[:, 4:]

    size0 = torch.stack([meta[:, 1], meta[:, 2]], dim=-1)
    dx = duv_dx * size0
    dy = duv_dy * size0
    lx2 = torch.sum(dx * dx, -1)
    ly2 = torch.sum(dy * dy, -1)
    lod = 0.5 * torch.log2(torch.clamp(torch.maximum(lx2, ly2), min=1e-12))
    if lod_bias:
        lod = lod + lod_bias
    max_lod = n_mips - 1.0
    lod = torch.minimum(torch.clamp(lod, min=0.0), max_lod)

    def level_fetch(level, at=uv):
        off = _select13(offs, level).to(torch.int32)
        return _fetch_level(rows, off, wrap, _mip_dim(w0, level), _mip_dim(h0, level), at)

    def trilinear(lod_, at=uv):
        l0 = torch.floor(lod_).to(torch.int32)
        l1 = torch.minimum(l0 + 1, max_lod.to(torch.int32))
        f = (lod_ - l0.to(torch.float32))[:, None]
        return level_fetch(l0, at) * (1 - f) + level_fetch(l1, at) * f

    if aniso:
        n_taps = max(int(quality[5:] or "4"), 1)
        major_is_x = lx2 >= ly2
        rho_maj2 = torch.clamp(torch.where(major_is_x, lx2, ly2), min=1e-12)
        rho_min2 = torch.clamp(torch.where(major_is_x, ly2, lx2), min=1e-12)
        rho_eff2 = torch.maximum(rho_min2, rho_maj2 / float(n_taps * n_taps))
        lod_a = 0.5 * torch.log2(rho_eff2)
        if lod_bias:
            lod_a = lod_a + lod_bias
        lod_a = torch.minimum(torch.clamp(lod_a, min=0.0), max_lod)
        maj_uv = torch.where(major_is_x[:, None], duv_dx, duv_dy)
        c = None
        for k in range(n_taps):
            t = (k + 0.5) / n_taps - 0.5
            tap = trilinear(lod_a, uv + maj_uv * t)
            c = tap if c is None else c + tap
        c = c / n_taps
    elif quality == "trilinear":
        c = trilinear(lod)
    elif quality == "stochastic1" and noise is not None and noise.ndim == 2:
        level = torch.round(torch.minimum(torch.clamp(lod + (noise[:, 0] - 0.5), min=0.0),
                                          max_lod)).to(torch.int32)
        off = _select13(offs, level).to(torch.int32)
        wl = _mip_dim(w0, level)
        hl = _mip_dim(h0, level)
        x = uv[:, 0] * wl.to(torch.float32) - 0.5 + (noise[:, 1] - 0.5)
        y = uv[:, 1] * hl.to(torch.float32) - 0.5 + (noise[:, 2] - 0.5)
        xi = torch.round(x).to(torch.int32)
        yi = torch.round(y).to(torch.int32)
        xi = torch.where(wrap == 0, xi & (wl - 1), torch.minimum(torch.clamp(xi, min=0), wl - 1))
        yi = torch.where(wrap == 0, yi & (hl - 1), torch.minimum(torch.clamp(yi, min=0), hl - 1))
        idx = torch.clamp(off + yi * wl + xi, 0, rows.shape[0] - 1)
        c = _unpack12(rows[idx.long()])
    elif quality == "stochastic" and noise is not None:
        u = noise[:, 0] if noise.ndim == 2 else noise
        lod_j = torch.minimum(torch.clamp(lod + (u - 0.5), min=0.0), max_lod)
        c = level_fetch(torch.round(lod_j).to(torch.int32))
    else:  # bilinear at the nearest mip (lod is clamped to the chain)
        c = level_fetch(torch.round(lod).to(torch.int32))

    n_xy = c[:, 4:6] * 2.0 - 1.0
    n_z = torch.sqrt(torch.clamp(1.0 - torch.sum(n_xy * n_xy, -1, keepdim=True), min=0.0))
    return MaterialSample(
        base=c[:, 0:4],
        normal_ts=torch.cat([n_xy, n_z], dim=-1),
        rough_metal=c[:, 6:8],
        emissive=c[:, 8:11],
        occlusion=c[:, 11],
    )
