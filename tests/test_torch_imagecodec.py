"""The port's image decoding and resizing (``assets/imagecodec``) against
PIL, the reference's decoder. Every case is exact: the port's pixels equal
PIL's bit for bit.

* JPEG: the DamagedHelmet's five 2048^2 textures (four baseline 4:2:0, one
  progressive 4:4:4), and small JPEGs PIL writes here: baseline at 4:2:0,
  4:2:2 and 4:4:4, greyscale, progressive, optimised Huffman tables, restart
  intervals, sides that are no multiple of 16, and planes of at most two
  chroma samples across (libjpeg's plain upsampling).
* LANCZOS: 2048 -> 128 and 2048 -> 256 on the albedo, an odd shape, a
  one-axis resize, and RGBA with varied alpha (Pillow's premultiplied path).
* PNG through ``decode_image`` (grey, grey + alpha, RGB, RGBA; the
  palette, 16-bit and interlaced kinds, once unsupported, as PIL reads
  them: test_torch_png.py holds every kind), and the unsupported kinds,
  each raising its named error.
* The decoder's build: concurrent builds in separate processes, and no
  compiler found, which raises instead of falling back.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from arkoserenderer_torch.assets import imagecodec
from arkoserenderer_torch.assets.imagecodec import decode_image, resize_lanczos

ROOT = Path(__file__).resolve().parents[1]
HELMET = ROOT / "assets" / "sample" / "DamagedHelmet"
TEXTURES = ("Default_albedo", "Default_normal", "Default_metalRoughness", "Default_emissive",
            "Default_AO")


def pil_rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


@pytest.fixture(scope="module")
def albedo():
    return decode_image((HELMET / "Default_albedo.jpg").read_bytes())


@pytest.mark.parametrize("name", TEXTURES)
def test_helmet_textures_equal_pil(name):
    data = (HELMET / f"{name}.jpg").read_bytes()
    ours = decode_image(data)
    assert ours.shape == (2048, 2048, 4) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, pil_rgba(data))


def _image(h, w, mode, seed=0):
    """A smooth gradient with noise, so every frequency band carries data."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                     (x + y) * 127 / max(h + w - 2, 1)], -1)
    img = np.clip(base + rng.normal(0, 40, base.shape), 0, 255).astype(np.uint8)
    return Image.fromarray(img[..., 0] if mode == "L" else img).convert(mode)


JPEG_CASES = {
    "baseline 4:2:0": ((48, 64), "RGB", dict(subsampling=2)),
    "baseline 4:2:2": ((48, 64), "RGB", dict(subsampling=1)),
    "baseline 4:4:4": ((48, 64), "RGB", dict(subsampling=0)),
    "greyscale": ((40, 56), "L", {}),
    "progressive 4:2:0": ((48, 64), "RGB", dict(progressive=True, subsampling=2)),
    "progressive 4:4:4": ((48, 64), "RGB", dict(progressive=True, subsampling=0)),
    "progressive greyscale": ((33, 21), "L", dict(progressive=True)),
    "optimised Huffman": ((48, 64), "RGB", dict(optimize=True)),
    "restart every 2 MCUs": ((48, 64), "RGB", dict(restart_marker_blocks=2)),
    "restart every MCU row, progressive": ((48, 64), "RGB",
                                           dict(restart_marker_rows=1, progressive=True)),
    "odd sides 4:2:0": ((37, 23), "RGB", dict(subsampling=2)),
    "odd sides 4:2:2 progressive": ((19, 45), "RGB", dict(subsampling=1, progressive=True)),
    "3x5 4:2:0 (two chroma columns)": ((5, 3), "RGB", dict(subsampling=2)),
    "1x1": ((1, 1), "RGB", dict(subsampling=2)),
    "quality 100": ((24, 40), "RGB", dict(quality=100)),
    "quality 5": ((24, 40), "RGB", dict(quality=5)),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_small_jpegs_equal_pil(case):
    (h, w), mode, kw = JPEG_CASES[case]
    buf = io.BytesIO()
    _image(h, w, mode).save(buf, "JPEG", **kw)
    data = buf.getvalue()
    ours = decode_image(data)
    assert ours.shape == (h, w, 4)
    np.testing.assert_array_equal(ours, pil_rgba(data), err_msg=case)


@pytest.mark.parametrize("size", [(128, 128), (256, 256), (300, 77), (2048, 512)])
def test_lanczos_equals_pil(albedo, size):
    ref = np.asarray(Image.fromarray(albedo).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos(albedo, size), ref)


@pytest.mark.parametrize("mode, shape, size", [
    ("RGBA", (37, 53, 4), (19, 71)),  # varied alpha: premultiplied RGBa
    ("RGB", (64, 40, 3), (17, 9)),
    ("L", (30, 50, 1), (50, 30)),      # upsampling on both axes
])
def test_lanczos_modes_equal_pil(mode, shape, size):
    img = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    pil = Image.fromarray(img[..., 0] if mode == "L" else img)
    assert pil.mode == mode
    ref = np.asarray(pil.resize(size, Image.LANCZOS)).reshape(size[1], size[0], shape[2])
    np.testing.assert_array_equal(resize_lanczos(img, size), ref)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_decode_png_as_pil(mode):
    rng = np.random.default_rng(5)
    ch = len(mode)
    img = rng.integers(0, 256, (13, 17, ch), dtype=np.uint8)
    buf = io.BytesIO()
    pil = Image.fromarray(img[..., 0] if ch == 1 else img)
    assert pil.mode == mode
    pil.save(buf, "PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_image(data), pil_rgba(data))


def _jpeg(**kw) -> bytes:
    buf = io.BytesIO()
    _image(16, 16, kw.pop("mode", "RGB")).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _set_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


def _adobe_rgb(data: bytes) -> bytes:
    """A JFIF baseline file rewritten with an Adobe APP14 marker, transform 0
    (RGB), in place of its JFIF APP0."""
    n = int.from_bytes(data[4:6], "big")
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return data[:2] + app14 + data[4 + n:]


def _png(mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    arr = np.arange(0, 64 * 1000 if mode == "I;16" else 64, 1000 if mode == "I;16" else 1)
    img = Image.fromarray(arr.astype(np.uint16 if mode == "I;16" else np.uint8).reshape(8, 8))
    (img if mode == "I;16" else img.convert(mode)).save(buf, "PNG", **kw)
    return buf.getvalue()


def _interlaced() -> bytes:
    """An Adam7-interlaced 8-bit greyscale PNG (test_torch_png.write_png)."""
    from test_torch_png import write_png

    return write_png(np.arange(64, dtype=np.uint8).reshape(8, 8, 1), interlace=True)


UNSUPPORTED = {
    "arithmetic coding (SOF9)": (lambda: _set_sof(_jpeg(), 0xC9), "arithmetic"),
    "progressive arithmetic coding (SOF10)": (lambda: _set_sof(_jpeg(), 0xCA), "arithmetic"),
    "lossless (SOF3)": (lambda: _set_sof(_jpeg(), 0xC3), "lossless"),
    "12-bit samples": (lambda: _set_sof(_jpeg(), 0xC1, precision=12), "12-bit"),
    "CMYK": (lambda: _jpeg(mode="CMYK"), "CMYK"),
    "RGB, Adobe transform 0": (lambda: _adobe_rgb(_jpeg()), "Adobe transform 0"),
    "palette PNG": (lambda: _png("P"), "palette"),
    "16-bit PNG": (lambda: _png("I;16"), "16-bit"),
    "interlaced PNG": (_interlaced, "interlaced"),
    "GIF": (lambda: b"GIF89a" + bytes(16), "JPEG and PNG only"),
}


# The PNG kinds listed above as unsupported, read since: PIL's pixels.
DECODED_SINCE = ("palette PNG", "16-bit PNG", "interlaced PNG")


@pytest.mark.parametrize("kind", sorted(UNSUPPORTED))
def test_unsupported_kinds_raise_by_name(kind):
    make, name = UNSUPPORTED[kind]
    if kind in DECODED_SINCE:
        data = make()
        np.testing.assert_array_equal(decode_image(data), pil_rgba(data))
        return
    with pytest.raises(NotImplementedError, match=name):
        decode_image(make())


def test_extended_huffman_sof1_decodes():
    """SOF1 (extended sequential, Huffman) at 8 bits reads as baseline."""
    data = _jpeg()
    np.testing.assert_array_equal(decode_image(_set_sof(data, 0xC1)), pil_rgba(data))


def test_corrupt_jpeg_raises_value_error():
    data = _jpeg()
    with pytest.raises(ValueError, match="corrupt JPEG"):
        decode_image(data[:len(data) // 3])


def test_no_compiler_raises(monkeypatch, tmp_path):
    """Without a host compiler the decoder does not build, and nothing
    decodes the file another way."""
    monkeypatch.setattr(imagecodec, "_lib", None)
    monkeypatch.setattr(imagecodec, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(imagecodec.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C compiler"):
        decode_image(_jpeg())
    assert not list(tmp_path.iterdir())


def test_concurrent_builds(tmp_path):
    """Four processes build the decoder into one empty directory at once;
    each compiles to its own name and renames it into place, so every one
    loads a whole library and decodes the same pixels."""
    data = tmp_path / "in.jpg"
    data.write_bytes(_jpeg())
    code = (
        "import sys, hashlib, pathlib\n"
        "from arkoserenderer_torch.assets import imagecodec\n"
        "imagecodec.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "img = imagecodec.decode_image(pathlib.Path(sys.argv[2]).read_bytes())\n"
        "print(hashlib.sha256(img.tobytes()).hexdigest())\n"
    )
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build), str(data)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    digests = {out.strip() for out, _ in outs}
    assert len(digests) == 1
    libs = list(build.iterdir())
    assert len(libs) == 1 and libs[0].suffix == ".so", libs
