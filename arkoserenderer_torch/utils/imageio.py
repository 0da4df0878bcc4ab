"""Minimal PNG reading and writing, and the float -> uint8 convention of
the goldens.

Reads every standard PNG with the standard library's zlib, so golden checks
and texture imports need no imaging package: greyscale at 1, 2, 4, 8 and 16
bits, grey + alpha, RGB and RGBA at 8 and 16 bits, palette images (PLTE,
with the alphas of tRNS) at 1, 2, 4 and 8 bits, a tRNS colour key on grey
and RGB, and Adam7 interlacing. The pixels are those PIL gives (the
reference reads images through ``Image.open(...).convert("RGBA")``): 16-bit
greyscale clamps to 255 (PIL's ``I;16`` mode), other 16-bit samples keep
their high byte, low-bit grey scales to 8 bits, and a colour key compares
the 8-bit pixel with the low byte of tRNS's raw value (times 255 at 1
bit). Writes 8-bit PNGs of grey, grey +
alpha, RGB and RGBA (filter 0 on every row, zlib and the chunks' CRC-32):
the apps' frames.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


# Adam7: (first column, first row, column step, row step) of each pass.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def to_u8(img) -> np.ndarray:
    """[0, 1] float image -> uint8 (round half up, as the goldens were made)."""
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _unfilter(raw: bytes, pos: int, h: int, stride: int, bpp: int) -> tuple[np.ndarray, int]:
    """The (h, stride) bytes of ``h`` filtered rows read from ``raw`` at
    ``pos`` (``bpp``: bytes a pixel, at least 1), and the position after
    them."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
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
    return out, pos


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, w, ch) samples of unfiltered rows: uint16 at 16 bits, else uint8
    (sub-byte samples unpacked, most significant bits first)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w * ch].reshape(h, w, ch).astype(np.uint8)


def _read(data: bytes):
    """(IHDR fields, (H, W, C) samples, PLTE bytes or None, tRNS bytes or
    None) of the PNG held in ``data``."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if ctype not in _CHANNELS and ctype != 3:
        raise ValueError(f"bad PNG colour type {ctype}")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"bad PNG bit depth {depth} for colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"bad PNG interlace method {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without a PLTE chunk")
    ch = _CHANNELS.get(ctype, 1)
    bits = ch * depth
    bpp = max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, h, (w * bits + 7) // 8, bpp)
        return hdr, _samples(rows, w, ch, depth), plte, trns
    img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no rows, not even filter bytes
        rows, pos = _unfilter(raw, pos, ph, (pw * bits + 7) // 8, bpp)
        img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    return hdr, img, plte, trns


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 pixels of the PNG held in ``data``, as PIL opens the
    file: C is 1 (grey), 2 (grey + alpha, or grey with a tRNS key), 3
    (RGB, or a palette without tRNS) or 4 (RGBA, RGB with a tRNS key, or a
    palette with tRNS)."""
    (_w, _h, depth, ctype, *_), img, plte, trns = _read(data)
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        colours = np.frombuffer(plte, np.uint8)[:768].reshape(-1, 3)
        pal[:len(colours), :3] = colours
        if trns is not None:
            alphas = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alphas), 3] = alphas
        return pal[img[..., 0]][..., :4 if trns is not None else 3]
    if ctype == 0:
        if depth == 16:
            out = np.minimum(img, 255).astype(np.uint8)  # PIL's I;16 -> 8 bits clamps
        else:
            out = img * np.uint8({1: 255, 2: 85, 4: 17, 8: 1}[depth])
    else:
        out = (img >> 8).astype(np.uint8) if depth == 16 else img
    if trns is not None and ctype in (0, 2):
        # The colour key as PIL applies it: tRNS's raw sample values (times
        # 255 at 1 bit), cut to their low byte, against the 8-bit pixel.
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns[:len(trns) // 2 * 2]))
        key = (key * (255 if depth == 1 else 1)) & 0xFF
        hit = np.all(out == key[:out.shape[2]], axis=2, keepdims=True)
        out = np.concatenate([out, np.where(hit, 0, 255).astype(np.uint8)], axis=2)
    return out


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
