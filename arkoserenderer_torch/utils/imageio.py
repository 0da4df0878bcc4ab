"""Minimal PNG reading and writing, and the float -> uint8 convention of
the goldens.

Reads 8-bit, non-interlaced greyscale, grey + alpha, RGB and RGBA PNGs with
the standard library's zlib, so golden checks and texture imports need no
imaging package. Palette, 16-bit and interlaced PNGs raise
NotImplementedError naming the kind. Writes 8-bit PNGs of those four kinds
(filter 0 on every row, zlib and the chunks' CRC-32): the apps' frames.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def to_u8(img) -> np.ndarray:
    """[0, 1] float image -> uint8 (round half up, as the goldens were made)."""
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # 1 sub, 3 average, 4 paeth: sequential along the row
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                elif ftype == 4:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[x] = (cur[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 samples of an 8-bit non-interlaced PNG held in
    ``data``: C is 1 (grey), 2 (grey + alpha), 3 (RGB) or 4 (RGBA)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if ctype == 3:
        raise NotImplementedError("palette PNG (colour type 3) is not supported")
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit PNG is not supported (8-bit only)")
    if interlace != 0:
        raise NotImplementedError("interlaced (Adam7) PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    ch = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return rows.reshape(h, w, ch)


def load_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 samples of the PNG file at ``path`` (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """PNG bytes of an (H, W) or (H, W, C) image, C in 1-4 (grey, grey +
    alpha, RGB, RGBA); a float image is converted with ``to_u8`` first."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = to_u8(a)
    if a.ndim == 2:
        a = a[..., None]
    h, w, ch = a.shape
    if ch not in _COLOUR_TYPE:
        raise ValueError(f"cannot write a PNG of {ch} channels")
    rows = np.zeros((h, 1 + w * ch), np.uint8)  # filter byte 0, then the samples
    rows[:, 1:] = np.ascontiguousarray(a).reshape(h, w * ch)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, img) -> None:
    """Write ``img`` (``encode_png``) to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def load_image_rgba(path: str) -> np.ndarray:
    """(H, W, 4) uint8 RGBA pixels of the PNG or JPEG file at ``path``, as
    PIL's ``Image.open(...).convert("RGBA")`` gives them."""
    from arkoserenderer_torch.assets.imagecodec import decode_image

    with open(path, "rb") as f:
        return decode_image(f.read())
