"""The port's PNG reader (``utils/imageio.decode_png`` through
``assets/imagecodec.decode_image``) against PIL's
``Image.open(...).convert("RGBA")``, the reference's reader: every case
equal bit for bit.

The fixtures are written into ``tmp_path``: by PIL where it writes the
kind (palette at 8 and 4 bits, with and without tRNS alphas; 1-bit grey;
16-bit grey, whose ``I;16`` conversion clamps at 255; grey and RGB with a
tRNS colour key), and by ``write_png`` below where it does not (16-bit
RGB, RGBA and grey + alpha, whose high byte PIL keeps; Adam7 interlacing
at 8 and 16 bits and for a palette). ``write_png`` cycles the five row
filters, so every unfilter path runs at every sample width.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from arkoserenderer_torch.assets.imagecodec import decode_image
from arkoserenderer_torch.utils.imageio import decode_png

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples a pixel -> PNG colour type (no palette)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(samples: np.ndarray, depth: int) -> bytes:
    """The rows of (h, w, c) 8- or 16-bit samples, row y filtered with
    filter type y % 5."""
    h = samples.shape[0]
    rows = (samples.astype(">u2") if depth == 16 else samples.astype(np.uint8)).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = samples.shape[2] * depth // 8
    out, prev = b"", np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) >> 1, _paeth(left, prev, up_left)][y % 5]
        out += bytes([y % 5]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return out


def write_png(samples: np.ndarray, depth: int = 8, interlace: bool = False,
              palette: np.ndarray | None = None, trns: bytes | None = None) -> bytes:
    """PNG bytes of (h, w, c) samples at 8 or 16 bits (c = 1 with
    ``palette``: indices into its (n, 3) colours), Adam7-interlaced when
    asked."""
    h, w, c = samples.shape
    ctype = 3 if palette is not None else COLOUR_TYPE[c]
    if interlace:
        raw = b"".join(_filtered(samples[y0::dy, x0::dx], depth)
                       for x0, y0, dx, dy in ADAM7 if x0 < w and y0 < h)
    else:
        raw = _filtered(samples, depth)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, int(interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def _samples(shape, depth, seed=0, high=None):
    rng = np.random.default_rng(seed)
    top = high if high is not None else 1 << depth
    return rng.integers(0, top, shape).astype(np.uint16 if depth == 16 else np.uint8)


def _palette_image(n_colours: int, seed: int = 1) -> Image.Image:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, n_colours, (11, 13)).astype(np.uint8), "P")
    img.putpalette(rng.integers(0, 256, 3 * n_colours).astype(np.uint8).tobytes())
    return img


PALETTE = np.random.default_rng(2).integers(0, 256, (16, 3))
CASES = {
    "palette": lambda: _pil_png(_palette_image(200)),
    "palette tRNS": lambda: _pil_png(_palette_image(200),
                                     transparency=bytes(range(0, 250, 5))),
    "palette 4-bit tRNS": lambda: _pil_png(_palette_image(16), bits=4,
                                           transparency=bytes([0, 128, 255, 7])),
    "grey 1-bit": lambda: _pil_png(Image.fromarray(_samples((9, 21), 8) > 127)),
    "grey tRNS": lambda: _pil_png(Image.fromarray(_samples((9, 7), 8, 3, high=8)),
                                  transparency=5),
    "RGB tRNS": lambda: _pil_png(Image.fromarray(_samples((9, 7, 3), 8, 4, high=3)),
                                 transparency=(1, 2, 0)),
    "grey 16-bit": lambda: _pil_png(Image.fromarray(_samples((10, 12), 16, 5, high=1000))),
    "grey 16-bit tRNS": lambda: _pil_png(Image.fromarray(_samples((10, 12), 16, 6, high=300)),
                                         transparency=256 + 7),
    "RGB 16-bit": lambda: write_png(_samples((7, 9, 3), 16, 7)),
    "RGBA 16-bit": lambda: write_png(_samples((7, 9, 4), 16, 8)),
    "grey + alpha 16-bit": lambda: write_png(_samples((7, 9, 2), 16, 9)),
    "Adam7 RGB": lambda: write_png(_samples((13, 11, 3), 8, 10), interlace=True),
    "Adam7 grey 16-bit": lambda: write_png(_samples((9, 17, 1), 16, 11), 16, interlace=True),
    "Adam7 RGBA 16-bit": lambda: write_png(_samples((5, 3, 4), 16, 12), 16, interlace=True),
    "Adam7 palette tRNS": lambda: write_png(_samples((10, 6, 1), 8, 13, high=16),
                                            interlace=True, palette=PALETTE,
                                            trns=bytes([9, 200, 0])),
    "Adam7 1x1": lambda: write_png(_samples((1, 1, 3), 8, 14), interlace=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_png_kinds_decode_as_pil(case, tmp_path):
    path = tmp_path / "fixture.png"
    path.write_bytes(CASES[case]())
    data = path.read_bytes()
    ref = np.asarray(Image.open(path).convert("RGBA"))
    ours = decode_image(data)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_16_bit_grey_clamps_and_colour_keys_compare_low_bytes():
    """PIL's rules, read off its output: 16-bit grey clamps to 255 (4000 ->
    255, not 4000 >> 8 = 15); a 16-bit key compares its low byte with the
    clamped pixel, so 256 + 7 keys out the 7."""
    data = write_png(np.array([[[7], [255], [4000]]], np.uint16), 16,
                     trns=struct.pack(">H", 256 + 7))
    np.testing.assert_array_equal(decode_png(data)[0],
                                  [[7, 0], [255, 255], [255, 255]])
    np.testing.assert_array_equal(decode_image(data), np.asarray(
        Image.open(io.BytesIO(data)).convert("RGBA")))


def test_corrupt_png_raises_value_error():
    data = write_png(_samples((4, 4, 3), 8))
    i = data.index(b"IHDR") + 4 + 9  # the colour type byte
    with pytest.raises(ValueError, match="colour type"):
        decode_png(data[:i] + b"\x05" + data[i + 1:])
    with pytest.raises(ValueError, match="bit depth"):
        decode_png(data[:i - 1] + b"\x04" + data[i:])
