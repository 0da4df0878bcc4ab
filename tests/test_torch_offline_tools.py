"""The port's offline tools (``arkoserenderer_torch/tools/cooker.py``,
``bake.py``, ``arkbake.py`` and ``gen_bluenoise.py``) against the reference's
root tools on the same inputs.

Inputs are written here from seeded numpy: a glTF quad with an external
buffer and a PNG texture, two PNGs, an IES profile, a .hair file, a text
file to copy, and the .arkmsh / .arklvl tree of ``tools/ark_level``. Every
comparison is exact: the baked scene arrays, the mip chains, the IES and
hair arrays equal; the .dds, the copies and the re-serialised .ark* files
byte for byte; the cooker's rebuild decisions the same (tests/test_aux.py's
dependency case); the blue-noise mask equal to the shipped file. The
reference's cooker fails on a hair rule (its tool calls a ``HairFile.parse``
that does not exist), so the port's hair output is held to the reference's
``HairFile.load`` instead.
"""

import importlib.util
import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from arkoserenderer_torch.utils.imageio import save_png

ROOT = Path(__file__).resolve().parents[1]

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

RULES = """
[[rule]]
name = "bake glTF scenes"
tool = "gltf"
input = "models/*.gltf"
output = "baked/{stem}.arkscene.npz"
max_texture = 16

[[rule]]
name = "image mip chains"
tool = "image"
input = "textures/*.png"
output = "baked/{stem}.mips.npz"

[[rule]]
name = "BC7 compress"
tool = "bc7"
input = "textures/*.png"
output = "baked/{stem}.dds"

[[rule]]
name = "IES photometric LUTs"
tool = "ies"
input = "lights/*.ies"
output = "baked/{stem}.ies.npz"

[[rule]]
name = "copy"
tool = "copy"
input = "misc/*.txt"
output = "baked/{name}"
"""
# The reference's hair tool calls HairFile.parse, which neither package's
# HairFile has: its cooker gets no hair rule, and the port's hair output is
# held to the reference's HairFile.load.
HAIR_RULE = """
[[rule]]
name = "hair strands"
tool = "hair"
input = "hair/*.hair"
output = "baked/{stem}.hair.npz"
"""


def root_tool(name: str):
    """The reference's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"root_tools_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_quad_gltf(folder: Path, rng) -> Path:
    """A textured quad: positions, normals, uvs and indices in quad.bin,
    its base colour in tex.png (18x10: resized on import)."""
    folder.mkdir(parents=True, exist_ok=True)
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3, 0, 0], np.uint16)  # two pad indices: 4-byte length
    blobs = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), idx.tobytes()]
    (folder / "quad.bin").write_bytes(b"".join(blobs))
    offs = np.concatenate([[0], np.cumsum([len(b) for b in blobs])])
    views = [{"buffer": 0, "byteOffset": int(offs[i]), "byteLength": len(b)}
             for i, b in enumerate(blobs)]
    acc = [{"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
            "min": [0, 0, 0], "max": [1, 1, 0]},
           {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
           {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
           {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"}]
    save_png(str(folder / "tex.png"), rng.integers(0, 256, (10, 18, 3), np.uint8))
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
           "nodes": [{"mesh": 0, "translation": [0.5, 0.0, -1.0]}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                      "TEXCOORD_0": 2},
                                       "indices": 3, "material": 0}]}],
           "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                   "roughnessFactor": 0.7}}],
           "textures": [{"source": 0}], "images": [{"uri": "tex.png"}],
           "buffers": [{"uri": "quad.bin", "byteLength": int(offs[-1])}],
           "bufferViews": views, "accessors": acc}
    path = folder / "quad.gltf"
    path.write_text(json.dumps(doc))
    return path


def write_hair(path: Path, rng) -> None:
    segs = np.array([2, 3, 1], np.uint16)
    n_points = int((segs + 1).sum())
    header = b"HAIR" + struct.pack("<IIII", 3, n_points, 1, 2) + struct.pack(
        "<ff", 0.1, 0.0) + struct.pack("<fff", 0.5, 0.3, 0.1)
    body = segs.tobytes() + rng.normal(size=(n_points, 3)).astype(np.float32).tobytes()
    path.write_bytes(header.ljust(128, b"\0") + body)


@pytest.fixture()
def tree(tmp_path):
    """The cooker's input tree under tmp_path/a, its rules file, and an
    identical copy under tmp_path/b for the reference's cooker."""
    rng = np.random.default_rng(19)
    a = tmp_path / "a"
    write_quad_gltf(a / "models", rng)
    (a / "textures").mkdir()
    for name, shape in (("a", (16, 16, 3)), ("b", (8, 16, 4))):
        save_png(str(a / "textures" / f"{name}.png"), rng.integers(0, 256, shape, np.uint8))
    (a / "lights").mkdir()
    (a / "lights" / "p.ies").write_text(IES_TEXT)
    (a / "hair").mkdir()
    write_hair(a / "hair" / "h.hair", rng)
    (a / "misc").mkdir()
    (a / "misc" / "notes.txt").write_text("cooked as is\n")
    shutil.copytree(a, tmp_path / "b")
    (a / "rules.toml").write_text(RULES + HAIR_RULE)
    (tmp_path / "b" / "rules.toml").write_text(RULES)
    return a, tmp_path / "b"


def assert_outputs_equal(ours: Path, ref: Path) -> None:
    if ours.suffix == ".npz":
        with np.load(ours) as x, np.load(ref) as y:
            assert sorted(x.files) == sorted(y.files), ours.name
            for k in x.files:
                assert x[k].dtype == y[k].dtype, (ours.name, k)
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{ours.name}:{k}")
    else:
        assert ours.read_bytes() == ref.read_bytes(), ours.name


def skipped_of(paths, hair):
    return [p for p in paths if p != hair]


def test_cooker_matches_the_root_cooker(tree):
    from arkoserenderer_torch.tools import cooker

    a, b = tree
    root_cooker = root_tool("cooker")

    def cook(folder, mod):
        res = mod.Cooker(folder / "rules.toml").cook()
        return (sorted(Path(p).relative_to(folder).as_posix() for p in res["built"]),
                sorted(Path(p).relative_to(folder).as_posix() for p in res["skipped"]))

    built, skipped = cook(a, cooker)
    hair = "baked/h.hair.npz"
    assert ([p for p in built if p != hair], skipped) == cook(b, root_cooker)
    assert len(built) == 8 and hair in built and not skipped
    for rel in built:
        if rel != hair:
            assert_outputs_equal(a / rel, b / rel)
    from arkoserenderer_tpu.assets.external import HairFile

    ref_hair = HairFile.load(str(a / "hair" / "h.hair"))
    with np.load(a / hair) as z:
        np.testing.assert_array_equal(z["points"], ref_hair.points)
        np.testing.assert_array_equal(z["segments"], np.asarray(ref_hair.segments, np.int64))
    assert (a / "baked" / "a.dds").read_bytes()[:4] == b"DDS "
    # A second run rebuilds nothing; touching one input rebuilds only its
    # outputs, a texture the glTF reads included.
    again = cook(a, cooker)
    assert again == ([], built) and cook(b, root_cooker) == ([], skipped_of(built, hair))
    rng = np.random.default_rng(2)
    img, tex = rng.integers(0, 256, (16, 16, 3), np.uint8), rng.integers(0, 256, (10, 18, 3),
                                                                          np.uint8)
    for folder in (a, b):
        save_png(str(folder / "textures" / "a.png"), img)
        save_png(str(folder / "models" / "tex.png"), tex)
    built2, skipped2 = cook(a, cooker)
    assert (built2, skipped_of(skipped2, hair)) == cook(b, root_cooker)
    assert built2 == ["baked/a.dds", "baked/a.mips.npz", "baked/quad.arkscene.npz"]
    assert len(skipped2) == 5
    for rel in built2:
        assert_outputs_equal(a / rel, b / rel)
    assert cooker.main([str(a / "rules.toml"), "--dry-run"]) == 0


def test_bake_and_arkbake_match_the_root_tools(tmp_path, capsys):
    from arkoserenderer_torch.tools import arkbake, bake
    from arkoserenderer_torch.tools.ark_level import write_level

    gltf = write_quad_gltf(tmp_path / "m", np.random.default_rng(4))
    bake.main([str(gltf), str(tmp_path / "ours.npz"), "--max-texture", "16", "--meshlets"])
    root_tool("bake").main([str(gltf), str(tmp_path / "ref.npz"), "--max-texture", "16",
                            "--meshlets"])
    assert_outputs_equal(tmp_path / "ours.npz", tmp_path / "ref.npz")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[2] and out[0].startswith("meshlets: ")

    paths = write_level(tmp_path / "tree")
    ref_arkbake = root_tool("arkbake")
    for key in ("sphere", "level", "box"):
        src = paths[key]
        ours, ref = tmp_path / f"ours{src.suffix}", tmp_path / f"ref{src.suffix}"
        assert arkbake.main(["arkbake", str(src), str(ours)]) == 0
        assert ref_arkbake.main(["arkbake", str(src), str(ref)]) == 0
        assert_outputs_equal(ours, ref)
    assert arkbake.main(["arkbake", str(paths["sphere"]), str(tmp_path / "x.arklvl")]) == 1
    assert arkbake.main(["arkbake", str(gltf), str(tmp_path / "x.gltf")]) == 1


def test_gen_bluenoise_reproduces_the_shipped_mask(tmp_path, monkeypatch):
    from arkoserenderer_torch.tools import gen_bluenoise

    shipped = ROOT / "arkoserenderer_torch" / "assets" / "data" / "bluenoise_128.npy"
    assert gen_bluenoise.OUT == shipped
    out = tmp_path / "bn.npy"
    monkeypatch.setattr(gen_bluenoise, "OUT", out)
    gen_bluenoise.main()
    ours, ref = np.load(out), np.load(shipped)
    assert ours.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(ours, ref)
