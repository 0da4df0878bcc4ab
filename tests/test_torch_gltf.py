"""The port's glTF importer (``assets/gltf``) against the JAX package's.

Both importers load the same file into their own Scene, and the test holds
the port's scene to the reference's, array for array and bit for bit:
segments (positions, normals, UVs, generated tangents, indices, skinning
and morph data), materials, texture pixels with their sRGB flag and wrap
mode, instances (transform, previous transform, LOD band, clip),
skeletons and animation channels.

* The DamagedHelmet as .gltf (external .bin and JPEGs) and as .glb (one
  binary chunk, images in buffer views), textures clamped to 64^2: the
  reference decodes and resizes with PIL, the port without it.
* Synthetic files written here: KHR_texture_transform (with texCoord and
  per-texture disagreement), emissive strength, masked and double-sided
  materials, a clamp sampler, a node hierarchy of TRS and matrix nodes;
  a sparse, strided, normalised accessor set without normals or indices;
  Draco, which both reject; and a one-joint skin with a clip on the joint
  (linear, step and cubic-spline channels), a morph target and a weights
  channel, whose skinned and morphed pool at one animated time equals the
  reference's (atol 1e-5: einsums on two backends, as
  test_torch_animation.py holds them).
"""

import base64
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from arkoserenderer_torch.assets import gltf as t_gltf
from arkoserenderer_torch.core.types import SceneLimits as TSceneLimits
from arkoserenderer_torch.ops import skinning as t_skin
from arkoserenderer_torch.scene.scene import Scene as TScene
from arkoserenderer_tpu.assets import gltf as j_gltf
from arkoserenderer_tpu.core.types import SceneLimits as JSceneLimits
from arkoserenderer_tpu.ops import skinning as j_skin
from arkoserenderer_tpu.scene.scene import Scene as JScene

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HELMET = ROOT / "assets" / "sample" / "DamagedHelmet"
LIMITS = dict(max_vertices=1 << 16, max_indices=3 << 16, max_drawables=64,
              max_materials=32, max_textures=32, texture_pool_texels=1 << 20)


def load_both(path, **kw):
    """(port scene, port result, reference scene, reference result)."""
    ts, js = TScene(limits=TSceneLimits(**LIMITS)), JScene(limits=JSceneLimits(**LIMITS))
    return ts, t_gltf.load_gltf(ts, path, **kw), js, j_gltf.load_gltf(js, path, **kw)


def _equal(name, ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, name
    np.testing.assert_array_equal(ours, ref, err_msg=name)


def assert_scenes_equal(ts, js):
    """Every segment, material, texture, instance, skeleton and clip of the
    port's scene equals the reference's."""
    assert len(ts.segments) == len(js.segments)
    for i, (a, b) in enumerate(zip(ts.segments, js.segments)):
        for f in ("positions", "normals", "uvs", "tangents", "indices", "material",
                  "skin_joints", "skin_weights", "skeleton", "morph_pos", "morph_nrm"):
            if getattr(b, f) is None:
                assert getattr(a, f) is None, (i, f)
            else:
                _equal(f"segment {i} {f}", getattr(a, f), getattr(b, f))
    assert len(ts.materials) == len(js.materials)
    for i, (a, b) in enumerate(zip(ts.materials, js.materials)):
        for f in type(b).__dataclass_fields__:
            _equal(f"material {i} {f}", getattr(a, f), getattr(b, f))
    ref_images = js.texture_builder.images
    assert len(ts.images) == len(ref_images)
    for i, ((img, srgb, wrap), (rimg, rsrgb, rwrap)) in enumerate(zip(ts.images, ref_images)):
        _equal(f"texture {i}", img, rimg)
        assert (srgb, wrap) == (rsrgb, rwrap), i
    assert len(ts.instances) == len(js.instances)
    for i, ((sid, w, pw, lod), (rsid, rw, rpw, rclip, rlod)) in enumerate(
            zip(ts.instances, js.instances)):
        assert sid == rsid and lod == rlod and ts.instance_clips.get(i) == rclip, i
        _equal(f"instance {i} world", w, rw)
        assert (pw is None) == (rpw is None), i
    assert len(ts.skeletons) == len(js.skeletons)
    for a, b in zip(ts.skeletons, js.skeletons):
        for f in type(b).__dataclass_fields__:
            _equal(f"skeleton {f}", getattr(a, f), getattr(b, f))
    assert len(ts.animations) == len(js.animations)
    for a, b in zip(ts.animations, js.animations):
        assert a.name == b.name and len(a.channels) == len(b.channels)
        for ca, cb in zip(a.channels, b.channels):
            assert (ca.target_joint, ca.path, ca.interpolation) == (
                cb.target_joint, cb.path, cb.interpolation)
            _equal("channel times", ca.times, cb.times)
            _equal("channel values", ca.values, cb.values)


@pytest.fixture(scope="module", params=["DamagedHelmet.gltf", "DamagedHelmet.glb"])
def helmet(request):
    return load_both(HELMET / request.param, max_texture_size=64)


def test_helmet_import_matches_reference(helmet):
    ts, tres, js, jres = helmet
    assert_scenes_equal(ts, js)
    assert (tres.segment_ids, tres.instance_count, tres.material_ids, tres.texture_ids) == (
        jres.segment_ids, jres.instance_count, jres.material_ids, jres.texture_ids)
    assert sum(len(s.indices) for s in ts.segments) == 3 * 15452
    # Five 2048^2 JPEGs clamped to 64^2 after the four default textures.
    assert [img.shape for img, *_ in ts.images[4:]] == [(64, 64, 4)] * 5
    assert len(tres.texture_ids) == 5


def test_helmet_import_builds_reference_pools(helmet):
    """Scene.build_host over the imported helmet: the vertex, index and
    packed-material pools equal the reference's build."""
    from arkoserenderer_torch import bridge
    from test_torch_scene import assert_field_equal

    ts, _, js, _ = helmet
    ours, ref = ts.build_host(), bridge.numpy_fields(js.build())
    for name in ("positions", "normals", "uvs", "tangents", "indices", "tri_valid", "world",
                 "mat_records", "mat_tex.rows"):
        assert_field_equal(name, ours[name], ref[name])


# -- synthetic files --------------------------------------------------------------------


class GltfWriter:
    """A glTF document with one buffer, built up accessor by accessor."""

    CTYPES = {np.float32: 5126, np.uint8: 5121, np.uint16: 5123, np.uint32: 5125}
    TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}

    def __init__(self):
        self.buf = bytearray()
        self.doc = {"asset": {"version": "2.0"}, "bufferViews": [], "accessors": []}

    def view(self, data: bytes, stride: int | None = None) -> int:
        self.buf += bytes(-len(self.buf) % 4)
        v = {"buffer": 0, "byteOffset": len(self.buf), "byteLength": len(data)}
        if stride:
            v["byteStride"] = stride
        self.buf += data
        self.doc["bufferViews"].append(v)
        return len(self.doc["bufferViews"]) - 1

    def accessor(self, arr, view: int | None = None, **extra) -> int:
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[:, None]
        acc = {"componentType": self.CTYPES[arr.dtype.type], "count": arr.shape[0],
               "type": self.TYPES[arr.shape[1]], **extra}
        acc["bufferView"] = self.view(arr.tobytes()) if view is None else view
        self.doc["accessors"].append(acc)
        return len(self.doc["accessors"]) - 1

    def write(self, path: Path) -> Path:
        self.doc["buffers"] = [{"byteLength": len(self.buf), "uri": (
            "data:application/octet-stream;base64," + base64.b64encode(self.buf).decode())}]
        path.write_text(json.dumps(self.doc))
        return path


def _image_uri(fmt: str, size=(8, 8)) -> str:
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size + (4,), dtype=np.uint8)
    img[..., 3] = np.where(img[..., 3] > 128, 255, 0)
    pil = Image.fromarray(img if fmt == "PNG" else img[..., :3])
    buf = io.BytesIO()
    pil.save(buf, fmt)
    mime = "image/png" if fmt == "PNG" else "image/jpeg"
    return f"data:{mime};base64," + base64.b64encode(buf.getvalue()).decode()


QUAD_POS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
QUAD_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
QUAD_IDX = np.array([0, 1, 2, 0, 2, 3], np.uint16)


def material_gltf(tmp_path) -> Path:
    """Two quads under a TRS parent and a matrix child; materials with
    KHR_texture_transform (one transform per material, and one material
    whose textures disagree), emissive strength, MASK and BLEND, double
    sides, a clamp sampler, a PNG (odd size: resized) and a JPEG."""
    g = GltfWriter()
    pos, nrm = g.accessor(QUAD_POS), g.accessor(np.tile([[0, 0, 1]], (4, 1)).astype(np.float32))
    uv0, uv1 = g.accessor(QUAD_UV), g.accessor(QUAD_UV * 0.5 + 0.25)
    idx = g.accessor(QUAD_IDX)
    ext = {"KHR_texture_transform": {"offset": [0.25, 0.5], "scale": [2.0, 3.0],
                                     "rotation": 0.3, "texCoord": 1}}
    g.doc.update({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [
            {"translation": [1, 2, 3], "rotation": [0, 0.3826834, 0, 0.9238795],
             "scale": [2, 2, 2], "children": [1], "mesh": 0},
            {"matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0.5, 0, -1, 1], "mesh": 1},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": pos, "NORMAL": nrm, "TEXCOORD_0": uv0,
                                            "TEXCOORD_1": uv1}, "indices": idx, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": pos, "NORMAL": nrm, "TEXCOORD_0": uv0},
                             "indices": idx, "material": 1},
                            {"attributes": {"POSITION": pos}, "mode": 1}]},  # lines: skipped
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0, "extensions": ext},
                                      "metallicRoughnessTexture": {"index": 1,
                                                                   "extensions": ext},
                                      "baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                                      "metallicFactor": 0.25, "roughnessFactor": 0.6},
             "normalTexture": {"index": 1, "extensions": ext},
             "emissiveTexture": {"index": 2}, "emissiveFactor": [1, 0.5, 0.25],
             "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 4.0}},
             "alphaMode": "MASK", "alphaCutoff": 0.3, "doubleSided": True},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 2, "extensions": {
                "KHR_texture_transform": {"offset": [0.1, 0.0]}}}},
             "occlusionTexture": {"index": 0, "extensions": {
                 "KHR_texture_transform": {"scale": [4.0, 4.0]}}},
             "alphaMode": "BLEND"},
        ],
        "samplers": [{"wrapS": 33071, "wrapT": 33071}, {"wrapS": 33648}],
        "textures": [{"source": 0, "sampler": 0}, {"source": 1, "sampler": 1}, {"source": 2}],
        "images": [{"uri": _image_uri("PNG", (12, 20))}, {"uri": _image_uri("PNG")},
                   {"uri": _image_uri("JPEG", (16, 16))}],
    })
    return g.write(tmp_path / "materials.gltf")


def png_kinds_gltf(tmp_path) -> Path:
    """A quad whose material's textures are the PNG kinds PIL reads for the
    reference: a palette with tRNS alphas, 16-bit greyscale and an Adam7
    16-bit RGB image (written by test_torch_png.write_png)."""
    from test_torch_png import write_png

    rng = np.random.default_rng(12)
    pngs = [write_png(rng.integers(0, 16, (8, 8, 1)).astype(np.uint8),
                      palette=rng.integers(0, 256, (16, 3)), trns=bytes([0, 90, 255, 30])),
            write_png(rng.integers(0, 600, (8, 8, 1)).astype(np.uint16), 16),
            write_png(rng.integers(0, 1 << 16, (8, 8, 3)).astype(np.uint16), 16,
                      interlace=True)]
    g = GltfWriter()
    attrs = {"POSITION": g.accessor(QUAD_POS), "TEXCOORD_0": g.accessor(QUAD_UV)}
    g.doc.update({
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs, "indices": g.accessor(QUAD_IDX),
                                    "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicRoughnessTexture": {"index": 1}},
                       "emissiveTexture": {"index": 2}, "emissiveFactor": [1, 1, 1],
                       "alphaMode": "BLEND"}],
        "textures": [{"source": i} for i in range(3)],
        "images": [{"uri": "data:image/png;base64," + base64.b64encode(d).decode()}
                   for d in pngs],
    })
    return g.write(tmp_path / "png_kinds.gltf")


def sparse_gltf(tmp_path) -> Path:
    """A triangle list without normals or indices: positions with a sparse
    substitution, normalised u8 UVs in a strided buffer view."""
    g = GltfWriter()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [2, 1, 0], [1, 2, 0]],
                   np.float32)
    sp_idx = g.view(np.array([1, 4], np.uint8).tobytes())
    sp_val = g.view(np.array([[1, 0, 0.5], [2, 1, -0.5]], np.float32).tobytes())
    p = g.accessor(pos, sparse={"count": 2,
                                "indices": {"bufferView": sp_idx, "componentType": 5121},
                                "values": {"bufferView": sp_val}})
    uv = np.zeros((6, 4), np.uint8)  # 2 bytes of UV every 4 bytes
    uv[:, :2] = [[0, 0], [255, 0], [0, 255], [255, 255], [128, 64], [64, 128]]
    uv_view = g.view(uv.tobytes(), stride=4)
    g.doc["accessors"].append({"bufferView": uv_view, "componentType": 5121, "count": 6,
                               "type": "VEC2", "normalized": True})
    g.doc.update({"scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
                  "meshes": [{"primitives": [{"attributes": {"POSITION": p,
                                                             "TEXCOORD_0": 1}}]}]})
    return g.write(tmp_path / "sparse.gltf")


def draco_gltf(tmp_path) -> Path:
    g = GltfWriter()
    pos = g.accessor(QUAD_POS)
    g.doc.update({"scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
                  "extensionsUsed": ["KHR_draco_mesh_compression"],
                  "meshes": [{"primitives": [{"attributes": {"POSITION": pos}, "extensions": {
                      "KHR_draco_mesh_compression": {"bufferView": 0}}}]}]})
    return g.write(tmp_path / "draco.gltf")


def skin_gltf(tmp_path) -> Path:
    """A strip of four quads skinned to one joint (a matrix node under a
    non-joint parent), with a morph target, and a clip: the joint's
    translation (linear), rotation (step) and scale (cubic spline), the
    morph weights, and a channel on a node that is no joint (skipped)."""
    g = GltfWriter()
    xs = np.linspace(0, 2, 5, dtype=np.float32)
    pos = np.concatenate([np.stack([xs, np.zeros(5), np.zeros(5)], -1),
                          np.stack([xs, np.ones(5), np.zeros(5)], -1)]).astype(np.float32)
    nrm = np.tile([[0, 0, 1]], (10, 1)).astype(np.float32)
    idx = np.array([[i, i + 1, i + 6, i, i + 6, i + 5] for i in range(4)], np.uint16).ravel()
    joints = np.zeros((10, 4), np.uint8)
    weights = np.zeros((10, 4), np.float32)
    weights[:, 0] = np.linspace(0.2, 2.0, 10)  # sums off 1: the import renormalises
    weights[3, 0] = 0.0  # a static vertex
    morph = np.zeros((10, 3), np.float32)
    morph[:, 2] = np.linspace(0, 0.5, 10)
    ibm = np.linalg.inv(np.array([[1, 0, 0, 0.5], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                                 np.float32)).T.astype(np.float32).reshape(1, 16)
    t_in = g.accessor(np.array([0.0, 0.5, 1.0], np.float32))
    acc = {
        "pos": g.accessor(pos), "nrm": g.accessor(nrm), "idx": g.accessor(idx),
        "j": g.accessor(joints), "w": g.accessor(weights),
        "mp": g.accessor(morph), "mn": g.accessor(np.full((10, 3), 0.1, np.float32)),
        "ibm": g.accessor(ibm),
        "tr": g.accessor(np.array([[0.5, 0, 0], [0.5, 0.4, 0], [0.5, 0.1, 0.2]], np.float32)),
        "rot": g.accessor(np.array([[0, 0, 0, 1], [0, 0, 0.3826834, 0.9238795],
                                    [0, 0, 0, 1]], np.float32)),
        "sc": g.accessor(np.array([[0, 0, 0], [1, 1, 1], [0, 0, 0], [0, 0, 0], [1.5, 1, 1],
                                   [0, 0, 0], [0, 0, 0], [1, 1, 1], [0, 0, 0]], np.float32)),
        "mw": g.accessor(np.array([0.0, 1.0, 0.25], np.float32)),
    }
    g.doc.update({
        "scene": 0, "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            {"translation": [0, 1, 0], "children": [1]},
            {"matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.5, 0, 0, 1]},
            {"mesh": 0, "skin": 0, "translation": [9, 9, 9]},  # ignored for skinned meshes
        ],
        "skins": [{"joints": [1], "inverseBindMatrices": acc["ibm"]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": acc["pos"], "NORMAL": acc["nrm"], "JOINTS_0": acc["j"],
                           "WEIGHTS_0": acc["w"]},
            "indices": acc["idx"],
            "targets": [{"POSITION": acc["mp"], "NORMAL": acc["mn"]}]}],
            "weights": [0.0]}],
        "animations": [{"name": "wave", "samplers": [
            {"input": t_in, "output": acc["tr"]},
            {"input": t_in, "output": acc["rot"], "interpolation": "STEP"},
            {"input": t_in, "output": acc["sc"], "interpolation": "CUBICSPLINE"},
            {"input": t_in, "output": acc["mw"]},
        ], "channels": [
            {"sampler": 0, "target": {"node": 1, "path": "translation"}},
            {"sampler": 1, "target": {"node": 1, "path": "rotation"}},
            {"sampler": 2, "target": {"node": 1, "path": "scale"}},
            {"sampler": 3, "target": {"node": 2, "path": "weights"}},
            {"sampler": 0, "target": {"node": 0, "path": "translation"}},  # no joint
        ]}],
    })
    return g.write(tmp_path / "skin.gltf")


@pytest.mark.parametrize("make", [material_gltf, sparse_gltf, skin_gltf, png_kinds_gltf],
                         ids=["materials", "sparse", "skin", "png kinds"])
def test_synthetic_imports_match_reference(tmp_path, make):
    ts, tres, js, jres = load_both(make(tmp_path), max_texture_size=8)
    assert_scenes_equal(ts, js)
    assert (tres.segment_ids, tres.instance_count, tres.material_ids, tres.texture_ids) == (
        jres.segment_ids, jres.instance_count, jres.material_ids, jres.texture_ids)


def test_texture_transform_baked_into_uvs(tmp_path):
    """uv' = T R S uv from the UV set the transform names (TEXCOORD_1)."""
    ts, *_ = load_both(material_gltf(tmp_path))
    c, s = np.cos(0.3), np.sin(0.3)
    m = np.array([[c * 2, s * 3], [-s * 2, c * 3]], np.float32)
    want = (QUAD_UV * 0.5 + 0.25) @ m.T + np.array([0.25, 0.5], np.float32)
    np.testing.assert_allclose(ts.segments[0].uvs, want, rtol=0, atol=1e-6)
    mat = ts.materials[1]
    assert mat.blend_mode == 1 and mat.double_sided and mat.alpha_cutoff == pytest.approx(0.3)
    np.testing.assert_allclose(mat.emissive_factor, [4, 2, 1])


def test_draco_rejected_by_both(tmp_path):
    path = draco_gltf(tmp_path)
    for mod, scene in ((t_gltf, TScene(limits=TSceneLimits(**LIMITS))),
                       (j_gltf, JScene(limits=JSceneLimits(**LIMITS)))):
        with pytest.raises(ValueError, match="KHR_draco_mesh_compression"):
            mod.load_gltf(scene, path)


def test_sparse_accessor_values(tmp_path):
    g = t_gltf.parse_gltf(sparse_gltf(tmp_path))
    pos = t_gltf.read_accessor(g, 0)
    np.testing.assert_array_equal(pos[[1, 4]], [[1, 0, 0.5], [2, 1, -0.5]])
    uv = t_gltf.read_accessor(g, 1)
    assert uv.dtype == np.float32 and uv[3].tolist() == [1.0, 1.0]


def test_skinned_morphed_pool_matches_reference(tmp_path):
    """The skin file's pool at t = 0.7: morph weights and palette from each
    package's update_animations, then the Scene pass's order (morphs, then
    skinning) through each package's ops."""
    ts, _, js, _ = load_both(skin_gltf(tmp_path))
    tst, jst = ts.static_info(), js.static_info()
    assert tst.has_skin and tst.morph_vertex_base == jst.morph_vertex_base == (0,)
    ours, ref = ts.build_host(), js.build()
    t_pal = ts.update_animations(0.7)
    j_pal = js.update_animations(0.7)
    np.testing.assert_allclose(t_pal, j_pal, rtol=0, atol=1e-6)
    tw, jw = ts.morph_weights(), js._morph_weights_list
    np.testing.assert_allclose(tw[0], jw[0], rtol=0, atol=1e-6)
    assert 0.0 < float(tw[0][0]) < 1.0
    tp, tn = t_skin.apply_morphs(*(torch.from_numpy(ours[k]) for k in ("positions", "normals")),
                                 torch.from_numpy(ours["morph_pos.0"]),
                                 torch.from_numpy(ours["morph_nrm.0"]),
                                 torch.from_numpy(tw[0]), 0)
    tp, tn, tt = t_skin.skin_vertices(tp, tn, torch.from_numpy(ours["tangents"]),
                                      torch.from_numpy(ours["skin_joints"]),
                                      torch.from_numpy(ours["skin_weights"]),
                                      torch.from_numpy(t_pal))
    jp, jn = j_skin.apply_morphs(ref.positions, ref.normals, ref.morph_pos[0], ref.morph_nrm[0],
                                 jnp.asarray(jw[0]), 0)
    jp, jn, jt = j_skin.skin_vertices(jp, jn, ref.tangents, ref.skin_joints, ref.skin_weights,
                                      jnp.asarray(j_pal))
    for name, o, r in (("positions", tp, jp), ("normals", tn, jn), ("tangents", tt, jt)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-5, err_msg=name)
    moved = np.abs(tp.numpy()[:10] - ours["positions"][:10]).max()
    assert moved > 0.1
