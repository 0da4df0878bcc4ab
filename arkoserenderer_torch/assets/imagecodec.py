"""Image decoding and resizing for asset import, without PIL.

The reference imports a glTF's textures with PIL: ``Image.open(...)
.convert("RGBA")`` and, for a texture over its size cap,
``resize(..., Image.LANCZOS)`` (arkoserenderer_tpu/assets/gltf.py:193-211).
This module gives the same pixels with no imaging package:

* ``decode_image(data)`` dispatches on the magic number. JPEG goes through
  the host C decoder ``csrc/jpeg_decode.c``, which gives libjpeg-turbo's
  pixels (islow IDCT, fancy upsampling, its YCbCr tables): baseline,
  extended-Huffman and progressive 8-bit files, greyscale or YCbCr. PNG goes
  through ``utils/imageio.decode_png``. The result is RGBA as PIL's
  ``convert("RGBA")`` gives it: grey repeated into RGB, alpha 255 where the
  file has none.
* ``resize_lanczos(img, (w, h))`` is Pillow's 8-bit LANCZOS resample in
  numpy: Pillow's float64 coefficients (support 3 x scale), then 22-bit
  fixed point with its rounding bias, the horizontal pass clipped to uint8,
  then the vertical pass; RGBA goes through premultiplied RGBa as Pillow's
  ``Image.resize`` does.

The decoder is host code, not a GPU kernel: it stands where PIL stands in
the reference. It is compiled at first use with the host C compiler (cc,
gcc, clang, c++ or g++, the first on PATH) into ``build/codec/``
at the checkout root; the library's name carries a hash of the source, so
an edit rebuilds. Without a compiler it raises; it never falls back to
another decoder. A kind of image it does not read raises
NotImplementedError naming the kind, a corrupt file ValueError.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from arkoserenderer_torch.utils.imageio import decode_png

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "codec"
CFLAGS = ["-O2", "-shared", "-fPIC"]
COMPILERS = ("cc", "gcc", "clang", "c++", "g++")

_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_UNSUPPORTED = 1  # the C entry points' code for a kind not supported (2: corrupt)

_lib: ctypes.CDLL | None = None


def host_compiler() -> str:
    """The host C compiler: the first of COMPILERS on PATH."""
    for name in COMPILERS:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C compiler found (none of cc, gcc, clang, c++, g++ on PATH): "
        "the JPEG decoder csrc/jpeg_decode.c is built with it at first use")


def build_decoder() -> ctypes.CDLL:
    """Compile ``csrc/jpeg_decode.c`` once per source version into
    ``BUILD_DIR`` and load it. Concurrent builds each compile to a name of
    their own and ``os.replace`` it into place."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libjpeg_decode_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cc = host_compiler()
        # Name the language: the source is also valid C++, for a C++ compiler.
        lang = ["-x", "c"] if not Path(cc).name.endswith(("++", "pp")) else ["-x", "c++"]
        res = subprocess.run([cc, *CFLAGS, *lang, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cc} failed to build {SOURCE.name} ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_header.argtypes = [p, n, ip, ip, ctypes.c_char_p, i]
    lib.jpeg_header.restype = i
    lib.jpeg_decode_rgba.argtypes = [p, n, p, i, i, ctypes.c_char_p, i]
    lib.jpeg_decode_rgba.restype = i
    _lib = lib
    return lib


def _raise(code: int, err: ctypes.Array) -> None:
    msg = err.value.decode(errors="replace")
    if code == _UNSUPPORTED:
        raise NotImplementedError(msg)
    raise ValueError(msg)


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA pixels of a JPEG file held in ``data``, as
    PIL's ``Image.open(...).convert("RGBA")`` gives them."""
    lib = build_decoder()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    w, h = ctypes.c_int(), ctypes.c_int()
    code = lib.jpeg_header(buf.ctypes.data, buf.size, ctypes.byref(w), ctypes.byref(h), err,
                           len(err))
    if code:
        _raise(code, err)
    out = np.empty((h.value, w.value, 4), np.uint8)
    code = lib.jpeg_decode_rgba(buf.ctypes.data, buf.size, out.ctypes.data, w.value, h.value,
                                err, len(err))
    if code:
        _raise(code, err)
    return out


def decode_image(data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA pixels of a JPEG or PNG file held in ``data``,
    as PIL's ``Image.open(...).convert("RGBA")`` gives them."""
    if data[:3] == _JPEG_MAGIC:
        return decode_jpeg(data)
    if data[:8] == _PNG_MAGIC:
        img = decode_png(data)
        ch = img.shape[2]
        rgb = img[..., :1].repeat(3, axis=2) if ch <= 2 else img[..., :3]
        alpha = img[..., -1:] if ch in (2, 4) else np.full(img.shape[:2] + (1,), 255, np.uint8)
        return np.ascontiguousarray(np.concatenate([rgb, alpha], axis=2))
    raise NotImplementedError(f"image format with magic {data[:8]!r} is not supported "
                              "(JPEG and PNG only)")


# -- Pillow's LANCZOS resample (libImaging/Resample.c) ----------------------------

PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0
RESAMPLE_BLOCK = 16  # outputs a matrix product of _resample_axis


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def lanczos_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    whole input range: (bounds (out, 2) int64 of first tap and tap count,
    coefficients (out, ksize) int64 in 22-bit fixed point, zero past each
    row's count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    kk = np.zeros((out_size, ksize), np.float64)
    bounds = np.zeros((out_size, 2), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:  # summed in order, as the C loop sums
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = w
        bounds[xx] = (xmin, xmax)
    scaled = kk * float(1 << PRECISION_BITS)
    fixed = np.trunc(np.where(kk < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int64)
    return bounds, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's resample along ``axis`` (1 horizontal, 0
    vertical) of an (H, W, C) uint8 image.

    Pillow sums 8-bit samples times 22-bit coefficients in an int32, and
    every partial sum of such products is an integer under 2**31 in
    magnitude, which float64 holds exactly in any order of summation. So
    each band of RESAMPLE_BLOCK outputs is one float64 matrix product over
    the input rows its taps reach, and equals Pillow's integer sum."""
    in_size = img.shape[axis]
    bounds, k = lanczos_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0)
    other = src.shape[1:]
    src = src.reshape(in_size, -1)
    out = np.empty((out_size, src.shape[1]), np.uint8)
    for o0 in range(0, out_size, RESAMPLE_BLOCK):
        o1 = min(o0 + RESAMPLE_BLOCK, out_size)
        lo, hi = int(bounds[o0, 0]), int((bounds[o0:o1, 0] + bounds[o0:o1, 1]).max())
        band = np.zeros((o1 - o0, hi - lo), np.float64)
        for r, (first, n) in enumerate(bounds[o0:o1]):
            band[r, first - lo:first - lo + n] = k[o0 + r, :n]
        acc = band @ src[lo:hi].astype(np.float64) + float(1 << (PRECISION_BITS - 1))
        out[o0:o1] = np.clip(np.floor(acc / float(1 << PRECISION_BITS)), 0, 255)
    return np.ascontiguousarray(np.moveaxis(out.reshape((out_size,) + other), 0, axis))


def _premultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa: each colour times alpha / 255, rounded as its
    MULDIV255 (the identity where alpha is 255)."""
    if (img[..., 3] == 255).all():
        return img
    a = img[..., 3:].astype(np.int32)
    t = img[..., :3].astype(np.int32) * a + 128
    out = img.copy()
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: colours times 255 / alpha (integer division,
    clipped), left as they are where alpha is 0 or 255."""
    a = img[..., 3:].astype(np.int32)
    if (a == 255).all():
        return img
    rgb = img[..., :3].astype(np.int32)
    div = np.clip(255 * rgb // np.maximum(a, 1), 0, 255)
    out = img.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), rgb, div)
    return out


def resize_lanczos(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) with ``size`` = (w, h), as PIL's
    ``Image.resize(size, Image.LANCZOS)`` resizes an image of mode L (C 1),
    RGB (3) or RGBA (4, through premultiplied RGBa)."""
    w, h = size
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"resize_lanczos takes (H, W, 1, 3 or 4) uint8, got {img.shape}")
    if (h, w) == img.shape[:2]:
        return img.copy()
    rgba = img.shape[2] == 4
    out = _premultiply(img) if rgba else img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return _unpremultiply(out) if rgba else out
