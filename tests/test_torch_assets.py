"""The port's baked scenes, BC7 codec and external formats against the JAX
package's copies of the same modules.

* ``save_baked`` by one package and ``load_baked`` by the other, both ways:
  the port's loaded scene and the reference's have equal ``build_host``
  arrays, every field (floats to test_torch_scene.py's 1e-6), and both
  equal the saved scene's but for the packed material pool. Neither
  package's ``load_baked`` restores the source images that pool is built
  from, so a loaded scene packs the default textures (``mat_tex`` and the
  texture lanes of ``mat_records``; ROADMAP R8). ``AssetCache`` hits and
  invalidates by mtime.
* BC7: ``compress_bc7_mode6``, ``compress_bc7`` at each quality and
  ``rdo_bc7`` give the reference's blocks on seeded 16x16 and 32x32 images;
  ``decompress_bc7`` equals it on a fuzz of all eight modes.
* BC4/BC5: ``compress_bc4`` and ``compress_bc5`` give the reference's
  blocks on tests/test_meshopt.py's images (random, flat, a smooth
  gradient) and tests/test_aux.py's BC5 pair, whose blocks the port's
  ``DDSImage`` reads as the reference's does. The reference encodes with
  its native library (built with g++, as here); its NumPy fallback rounds
  an exact .5 to even where the library rounds it away from zero, and
  gives other blocks on the random images.
* ``DDSImage`` (uncompressed with mips, BC1, BC3, BC5, BC7 through the DX10
  header), ``IESProfile`` (``parse``, ``load``, ``to_lut``) and
  ``HairFile`` against the reference's.
"""

import os
import struct
import time

import numpy as np
import pytest

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets import baked as tbaked
from arkoserenderer_torch.assets import bc7 as tbc7
from arkoserenderer_torch.assets import external as text
from arkoserenderer_torch.assets import meshopt as tmeshopt
from arkoserenderer_tpu.assets import baked as jbaked
from arkoserenderer_tpu.assets import bc7 as jbc7
from arkoserenderer_tpu.assets import external as jext
from arkoserenderer_tpu.assets import meshopt as jmeshopt
from test_torch_scene import assert_field_equal

# build_host keys that load_baked does not restore (see the docstring).
PACKED_TEXTURE_KEYS = ("mat_tex.", "mat_records")


def baked_scene(pkg: str):
    """The test scene of either package with a second texture, a spot, a
    point light, a skeleton and a clip."""
    import importlib

    root = {"jax": "arkoserenderer_tpu", "torch": "arkoserenderer_torch"}[pkg]
    proc = importlib.import_module(f"{root}.assets.procedural")
    lights = importlib.import_module(f"{root}.scene.lights")
    anim = importlib.import_module(f"{root}.scene.animation")
    sc = importlib.import_module(f"{root}.scene.scene")
    rng = np.random.default_rng(21)
    scene, _ = proc.build_test_scene(viewport=(64, 64), n_spheres=2)
    tex = scene.add_texture(rng.integers(0, 256, (16, 32, 4), dtype=np.uint8), srgb=True)
    nrm = scene.add_texture(rng.integers(0, 256, (8, 8, 4), dtype=np.uint8), srgb=False)
    mat = scene.add_material(sc.Material(base_color_tex=tex, normal_tex=nrm, metallic_factor=0.4,
                                         blend_mode=sc.BLEND_TRANSLUCENT, double_sided=True))
    box = proc.make_box((0.5, 0.5, 0.5))
    box.material = mat
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (0.0, 2.0, 1.0)
    scene.add_instance(scene.add_segment(box), w)
    scene.spots.append(lights.SpotLight(position=np.array([1.0, 3.0, 1.0], np.float32),
                                        direction=np.array([0.0, -1.0, 0.0], np.float32),
                                        luminous_intensity_cd=9000.0))
    scene.points.append(lights.PointLight(position=np.array([-1.0, 1.0, 2.0], np.float32)))
    scene.add_skeleton(anim.Skeleton(
        parents=np.array([-1, 0], np.int32), inverse_bind=np.tile(np.eye(4, dtype=np.float32),
                                                                  (2, 1, 1)),
        rest_translation=np.zeros((2, 3), np.float32),
        rest_rotation=np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1)),
        rest_scale=np.ones((2, 3), np.float32)))
    scene.add_animation(anim.AnimationClip(channels=[anim.AnimChannel(
        target_joint=1, path="translation", times=np.array([0.0, 1.0], np.float32),
        values=np.array([[0, 0, 0], [0, 1, 0]], np.float32))], name="lift"))
    return scene


def _host(scene) -> dict:
    """A scene's build_host arrays, for either package's Scene."""
    if hasattr(scene, "build_host"):
        return scene.build_host()
    return bridge.numpy_fields(scene.build())


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch", "torch_to_torch"])
def test_baked_scene_loads_in_the_other_package(direction, tmp_path):
    src, dst = direction.split("_to_")
    save = {"torch": tbaked.save_baked, "jax": jbaked.save_baked}[src]
    scene = baked_scene(src)
    path = tmp_path / "scene.arkscene.npz"
    save(scene, path)
    loaded = {"torch": tbaked.load_baked(path, limits=scene.limits),
              "jax": jbaked.load_baked(path, limits=scene.limits)}
    got = loaded[dst]
    assert len(got.segments) == len(scene.segments) and len(got.spots) == 1
    assert len(got.skeletons) == len(got.animations) == 1
    np.testing.assert_array_equal(got.skeletons[0].parents, [-1, 0])
    assert got.animations[0].name == "lift"
    want = _host(scene)
    host = {k: _host(v) for k, v in loaded.items()}
    # The port's fields; the reference's hold more (its BVH and hair pools).
    keys = set(host["torch"])
    assert keys <= set(want) and keys <= set(host["jax"])
    for name in sorted(keys):
        # The two packages load the file alike, every field.
        assert_field_equal(name, host["torch"][name], host["jax"][name])
        if not name.startswith(PACKED_TEXTURE_KEYS):
            assert_field_equal(name, host[dst][name], want[name])
    # A loaded scene packs the default textures (R8), in both packages.
    assert not np.array_equal(host[dst]["mat_tex.rows"], want["mat_tex.rows"])
    for pkg, sc in loaded.items():
        assert sc.texture_builder._count == scene.texture_builder._count, pkg


def test_baked_version_and_magic_are_checked(tmp_path):
    path = tmp_path / "bad.npz"
    np.savez(path, __meta__=np.frombuffer(b'{"magic": "ARKS", "version": 9}', np.uint8))
    with pytest.raises(ValueError, match="version"):
        tbaked.load_baked(path)
    np.savez(path, __meta__=np.frombuffer(b'{"magic": "XXXX", "version": 1}', np.uint8))
    with pytest.raises(ValueError, match="ARKS"):
        tbaked.load_baked(path)


def test_asset_cache(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("1")
    cache, calls = tbaked.AssetCache(), []

    def loader(path):
        calls.append(path)
        return open(path).read()

    assert cache.load(p, loader) == cache.load(p, loader) == "1" and len(calls) == 1
    time.sleep(0.01)
    p.write_text("2")
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert cache.load(p, loader) == "2" and len(calls) == 2
    cache.clear()
    assert cache.load(p, loader) == "2" and len(calls) == 3


# -- BC7 -----------------------------------------------------------------------------


def bc7_image(size: int, alpha: bool, seed: int) -> np.ndarray:
    """Smooth colour with noise, a two-tone rectangle (partitions pay off)
    and, with ``alpha``, an alpha ramp."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 5), 128 + 100 * np.cos(y / 7),
                    128 + 80 * np.sin((x + y) / 6), np.full_like(x, 255)], -1)
    img[..., :3] = np.clip(img[..., :3] + rng.normal(0, 6, (size, size, 3)), 0, 255)
    img[size // 4:size // 2, 2:size - 3, :3] = (230, 40, 40)
    if alpha:
        img[..., 3] = np.clip(x * (255 / size) + rng.normal(0, 8, x.shape), 0, 255)
    return img.astype(np.uint8)


def rdo_image(size: int, alpha: bool) -> np.ndarray:
    """Two flat halves under faint noise: blocks the rate-distortion pass
    can make byte-identical to a neighbour."""
    rng = np.random.default_rng(size)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255 if not alpha else 180
    img[..., :3] = (90, 120, 150)
    img[:, : size // 2, :3] = (200, 80, 60)
    img[..., :3] = np.clip(img[..., :3] + rng.normal(0, 3, (size, size, 3)), 0, 255)
    return img


@pytest.mark.parametrize("size", [16, 32])
@pytest.mark.parametrize("encoder", ["mode6", "fast", "balanced", "thorough", "rdo"])
def test_bc7_encoders_match_reference(encoder, size):
    for alpha in (False, True):
        img = bc7_image(size, alpha, seed=size + alpha)
        if encoder == "mode6":
            ours, ref = tbc7.compress_bc7_mode6(img), jbc7.compress_bc7_mode6(img)
        elif encoder == "rdo":
            img = rdo_image(size, alpha)
            base = jbc7.compress_bc7(img, quality="balanced")
            ours, ref = tbc7.rdo_bc7(img, base, 4.0), jbc7.rdo_bc7(img, base, 4.0)
            assert not np.array_equal(ref, base)   # the pass changed blocks
        else:
            ours = tbc7.compress_bc7(img, quality=encoder)
            ref = jbc7.compress_bc7(img, quality=encoder)
        assert ours.shape == ((size // 4) ** 2, 16) and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
        out = tbc7.decompress_bc7(ours, size, size)
        assert np.abs(out.astype(int) - img.astype(int)).mean() < 25


@pytest.mark.parametrize("mode", range(8))
def test_bc7_decoder_matches_reference_on_every_mode(mode):
    """Random bits behind a forced mode marker are valid blocks: every
    partition, p-bit, rotation and index set of the mode."""
    rng = np.random.default_rng(100 + mode)
    n = 512
    raw = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    b0 = raw[:, 0].astype(np.int64)
    raw[:, 0] = (((b0 >> (mode + 1)) << (mode + 1)) | (1 << mode)).astype(np.uint8)
    ours = tbc7.decompress_bc7(raw, 16, 4 * n // 4)
    np.testing.assert_array_equal(ours, jbc7.decompress_bc7(raw, 16, 4 * n // 4))
    np.testing.assert_array_equal(tbc7.decompress_bc7(raw, 4, 4 * n),
                                  jbc7.decompress_bc7(raw, 4, 4 * n))


# -- DDS, IES, .hair -------------------------------------------------------------------


def _dds_header(width, height, n_mips, *, fourcc=None, bitcount=0, masks=None):
    """tests/test_aux.py's DDS header."""
    pf_flags = 0x4 if fourcc else 0x40 | 0x1
    rm, gm, bm, am = masks or (0, 0, 0, 0)
    pf = struct.pack("<II4sIIIII", 32, pf_flags, fourcc or b"\0\0\0\0", bitcount, rm, gm, bm, am)
    hdr = struct.pack("<7I", 124, 0x21007, height, width, 0, 0, n_mips)
    return b"DDS " + hdr + b"\0" * 44 + pf + b"\0" * 20


def dds_cases() -> dict:
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (8, 12, 4), np.uint8)

    def bgra(m):
        u = (m[..., 2].astype(np.uint32) | (m[..., 1].astype(np.uint32) << 8)
             | (m[..., 0].astype(np.uint32) << 16) | (m[..., 3].astype(np.uint32) << 24))
        return u.astype("<u4").tobytes()

    cases = {"rgba_mips": _dds_header(12, 8, 3, bitcount=32,
                                      masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
             + bgra(img) + bgra(img[::2, ::2]) + bgra(img[::4, ::4])}
    bc1 = rng.integers(0, 256, (6, 8), dtype=np.uint8)
    cases["bc1"] = _dds_header(12, 8, 1, fourcc=b"DXT1") + bc1.tobytes()
    bc3 = rng.integers(0, 256, (6, 16), dtype=np.uint8)
    cases["bc3"] = _dds_header(12, 8, 1, fourcc=b"DXT5") + bc3.tobytes()
    cases["bc5"] = _dds_header(12, 8, 1, fourcc=b"ATI2") + bc3.tobytes()
    blocks = jbc7.compress_bc7(bc7_image(16, True, 3), quality="balanced")
    pf = struct.pack("<II4sIIIII", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    cases["bc7_dx10"] = (b"DDS " + struct.pack("<7I", 124, 0x1007, 16, 16, 0, 0, 1)
                         + b"\0" * 44 + pf + b"\0" * 20 + struct.pack("<5I", 98, 3, 0, 1, 0)
                         + blocks.tobytes())
    return cases


@pytest.mark.parametrize("case", ["rgba_mips", "bc1", "bc3", "bc5", "bc7_dx10"])
def test_dds_matches_reference(case, tmp_path):
    data = dds_cases()[case]
    ours, ref = text.DDSImage.parse(data), jext.DDSImage.parse(data)
    assert (ours.width, ours.height, ours.fourcc) == (ref.width, ref.height, ref.fourcc)
    assert len(ours.mips) == len(ref.mips) == (3 if case == "rgba_mips" else 1)
    for a, b in zip(ours.mips, ref.mips):
        assert a.dtype == np.uint8 and a.shape[-1] == 4
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "x.dds"
    path.write_bytes(data)
    np.testing.assert_array_equal(text.DDSImage.load(str(path)).mips[0], ref.mips[0])
    with pytest.raises(ValueError):
        text.DDSImage.parse(b"XXXX" + data[4:])


def bc_channel(case: str, seed: int = 0) -> np.ndarray:
    """tests/test_meshopt.py's BC4 inputs: random 32x32 and 16x16, a flat
    8x8 block pair (137) and a 16x16 horizontal gradient 40..80."""
    rng = np.random.default_rng(seed)
    if case == "flat 8x8":
        return np.full((8, 8), 137, np.uint8)
    if case == "gradient 16x16":
        return np.tile(np.linspace(40, 80, 16).astype(np.uint8)[None, :], (16, 1))
    n = 32 if case == "random 32x32" else 16
    return rng.integers(0, 256, (n, n), dtype=np.uint8)


@pytest.mark.parametrize("case", ["random 32x32", "random 16x16", "flat 8x8", "gradient 16x16"])
def test_bc4_encoder_matches_reference(case):
    img = bc_channel(case)
    ours = tmeshopt.compress_bc4(img)
    np.testing.assert_array_equal(ours, jmeshopt.compress_bc4(img))
    assert ours.shape == (img.size // 16, 8) and ours.dtype == np.uint8
    back = tmeshopt.decompress_bc4(ours, *img.shape)
    np.testing.assert_array_equal(back, jmeshopt.decompress_bc4(ours, *img.shape))
    with pytest.raises(ValueError, match="multiples of 4"):
        tmeshopt.compress_bc4(img[:, :-2])


@pytest.mark.parametrize("size", [16, 8])
def test_bc5_encoder_matches_reference(size):
    """tests/test_meshopt.py's 16x16 layout case and tests/test_aux.py's
    8x8 pair in an ATI2 DDS, read by both packages' DDSImage."""
    rng = np.random.default_rng(4)
    r, g = (rng.integers(0, 256, (size, size), np.uint8) for _ in range(2))
    ours = tmeshopt.compress_bc5(r, g)
    np.testing.assert_array_equal(ours, jmeshopt.compress_bc5(r, g))
    assert ours.shape == ((size // 4) ** 2, 16)
    data = _dds_header(size, size, 1, fourcc=b"ATI2") + ours.tobytes()
    np.testing.assert_array_equal(text.DDSImage.parse(data).mips[0],
                                  jext.DDSImage.parse(data).mips[0])


IES_TEXT = """IESNA:LM-63-2002
[TEST] two planes
TILT=NONE
1 -1 1.5 5 2 1 2 0 0 0
1.0 1.0 0
0 22.5 45 67.5 90
0 90
1000 900 600 200 10
1000 700 500 100 0
"""


def test_ies_profile_matches_reference(tmp_path):
    ours, ref = text.IESProfile.parse(IES_TEXT), jext.IESProfile.parse(IES_TEXT)
    for f in ("vertical_angles", "horizontal_angles", "candela"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    for res in (64, 256):
        np.testing.assert_array_equal(ours.to_lut(res), ref.to_lut(res))
    assert ours.to_lut()[0] == 1.0 and ours.to_lut()[-1] < 0.01
    path = tmp_path / "p.ies"
    path.write_text(IES_TEXT)
    np.testing.assert_array_equal(text.IESProfile.load(str(path)).candela, ref.candela)


@pytest.mark.parametrize("flags", [0, 3])
def test_hair_file_matches_reference(flags, tmp_path):
    """A .hair file with the default segment count (flags 0), or with
    per-strand segments and per-point thickness (flags 3)."""
    rng = np.random.default_rng(flags)
    segs = np.array([2, 3, 1], np.uint16)
    n_points = int((segs + 1).sum())
    header = b"HAIR" + struct.pack("<IIII", 3, n_points, flags, 2) + struct.pack(
        "<ff", 0.1, 0.0) + struct.pack("<fff", 0.5, 0.3, 0.1)
    body = segs.tobytes() if flags & 1 else b""
    body += rng.normal(size=(n_points, 3)).astype(np.float32).tobytes()
    if flags & 2:
        body += rng.uniform(0.01, 0.1, n_points).astype(np.float32).tobytes()
    path = tmp_path / "h.hair"
    path.write_bytes(header.ljust(128, b"\0") + body)
    ours, ref = text.HairFile.load(str(path)), jext.HairFile.load(str(path))
    np.testing.assert_array_equal(ours.points, ref.points)
    np.testing.assert_array_equal(ours.segments, ref.segments)
    assert ours.num_strands == ref.num_strands == 3
    assert ours.default_thickness == ref.default_thickness
    if flags & 2:
        np.testing.assert_array_equal(ours.thickness, ref.thickness)
    else:
        assert ours.thickness is ref.thickness is None
