"""Minimal PNG reading and the float -> uint8 convention of the goldens.

Reads 8-bit, non-interlaced greyscale, grey + alpha, RGB and RGBA PNGs with
the standard library's zlib, so golden checks and texture imports need no
imaging package. Palette, 16-bit and interlaced PNGs raise
NotImplementedError naming the kind.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


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
