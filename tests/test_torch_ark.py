"""The port's .ark* formats (``assets/ark.py``, ``assets/cereal_binary.py``)
against the JAX package's copies of the same modules.

* ``cereal_binary.encode`` gives the reference's bytes for a document of
  every kind (mesh, material, level, skeleton, animation, set, hair), and
  ``decode`` gives equal documents.
* The asset tree of ``tools/ark_level.write_level`` (written by the port's
  writers: a binary and a JSON .arkmsh, a JSON and a binary .arkmat with a
  PNG, an .arkset, a BC7 .dds sky and an .arklvl) loaded into the port's
  Scene and into the reference's: every ``build_host`` array equal, floats
  to test_torch_scene.py's 1e-6 (a light's direction is a quaternion
  rotation, which XLA computes with fused multiply-adds in the reference).
* .arkskel / .arkanim written by one package and read by both drive equal
  poses; ``LevelDocument`` edits, ``sync_from_scene`` and ``write`` give
  the reference's file; .arkhair strands (alone or named by a level
  object) load into the reference's scene.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets import ark as tark
from arkoserenderer_torch.assets import cereal_binary as tcb
from arkoserenderer_torch.core.types import SceneLimits as TLimits
from arkoserenderer_torch.scene.scene import Scene as TScene
from arkoserenderer_torch.tools.ark_level import material_doc, mesh_doc, write_level
from arkoserenderer_tpu.assets import ark as jark
from arkoserenderer_tpu.assets import cereal_binary as jcb
from arkoserenderer_tpu.core.types import SceneLimits as JLimits
from arkoserenderer_tpu.scene.scene import Scene as JScene
from test_torch_scene import assert_field_equal

LIMITS = dict(max_vertices=1 << 14, max_indices=3 << 14, max_drawables=64, max_materials=16,
              max_textures=16, texture_pool_texels=1 << 16)


def scenes():
    return TScene(TLimits(**LIMITS)), JScene(JLimits(**LIMITS))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_level(tmp_path_factory.mktemp("arktree"))


def assert_doc_equal(a, b, path="doc"):
    """Two decoded documents equal: dicts key by key, arrays by value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_doc_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_doc_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _skeleton(mod):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(4, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return mod.Skeleton(
        parents=np.array([-1, 0, 1, 1], np.int32),
        inverse_bind=np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        + rng.normal(0, 0.01, (4, 4, 4)).astype(np.float32),
        rest_translation=rng.normal(size=(4, 3)).astype(np.float32),
        rest_rotation=q, rest_scale=np.ones((4, 3), np.float32))


def _clip(mod):
    rng = np.random.default_rng(9)
    t = np.array([0.0, 0.4, 1.0], np.float32)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return mod.AnimationClip(channels=[
        mod.AnimChannel(target_joint=1, path="rotation", times=t, values=q, interpolation=1),
        mod.AnimChannel(target_joint=2, path="translation", times=t,
                        values=rng.normal(size=(3, 3)).astype(np.float32), interpolation=0),
        mod.AnimChannel(target_joint=3, path="scale", times=t[:2],
                        values=np.ones((2, 3), np.float32) * 1.5, interpolation=1),
    ], name="wave")


def documents(tmp_path: Path) -> dict:
    """One document of every kind, as the JSON flavor reads it."""
    from arkoserenderer_torch.assets.procedural import make_uv_sphere
    from arkoserenderer_torch.scene import animation as tanim

    rng = np.random.default_rng(4)
    out = {".arkmsh": mesh_doc(make_uv_sphere(0.5, 6, 8), "assets/m.arkmat", "s",
                               as_json=False),
           ".arkmat": material_doc((0.5, 0.25, 1.0, 0.7), "Translucent", "assets/a.png",
                                   metallic=0.3, double_sided=True)}
    tark.save_arkskel(tmp_path / "k.arkskel", _skeleton(tanim), ["a", "b", "c", "d"])
    tark.save_arkanim(tmp_path / "k.arkanim", _clip(tanim), ["a", "b", "c", "d"])
    tark.save_arkset(tmp_path / "k.arkset", {"name": "r", "meshIndex": 0, "children": [
        {"name": "c", "meshIndex": 1, "children": [{"name": "g"}]}]}, ["x.arkmsh", "y.arkmsh"])
    tark.save_arkhair(tmp_path / "k.arkhair", rng.normal(size=(12, 3)),
                      np.array([3, 3, 3]), thickness=rng.uniform(0.01, 0.1, 12))
    for ext, key in ((".arkskel", "skeleton"), (".arkanim", "animation"),
                     (".arkset", "set"), (".arkhair", "hair")):
        out[ext] = tark.read_ark_document(tmp_path / f"k{ext}", key)
    return out


@pytest.mark.parametrize("ext", [".arkmsh", ".arkmat", ".arklvl", ".arkskel", ".arkanim",
                                 ".arkset", ".arkhair"])
def test_cereal_binary_bytes_match_reference(ext, tmp_path, tree):
    doc = (jark.read_ark_document(tree["level"], "level") if ext == ".arklvl"
           else documents(tmp_path)[ext])
    ours, ref = tcb.encode(ext, doc), jcb.encode(ext, doc)
    assert ours == ref and tcb.sniff_binary(ours)[0] == jcb.sniff_binary(ref)[0]
    assert_doc_equal(tcb.decode(ours), jcb.decode(ref))
    assert tcb.encode(ext, tcb.decode(ours)) == ours   # byte-stable
    path = tmp_path / f"w{ext}"
    tcb.write_ark_binary(path, doc)
    assert path.read_bytes() == ref


def load_both(kind: str, tree, tmp_path=None):
    """The asset of ``kind`` loaded into a port Scene and a reference Scene:
    (port scene, reference scene, port result, reference result)."""
    ts, js = scenes()
    if kind == "arkmat":
        rt, rj = tark.load_arkmat(ts, tree["opaque"]), jark.load_arkmat(js, tree["opaque"])
        rt = (rt, tark.load_arkmat(ts, tree["glass"]))
        rj = (rj, jark.load_arkmat(js, tree["glass"]))
        for s, mod in ((ts, tark), (js, jark)):   # something to draw them
            from importlib import import_module
            proc = import_module(mod.__name__.replace("assets.ark", "assets.procedural"))
            for mid in (1, 2):
                box = proc.make_box((1.0, 1.0, 1.0))
                box.material = mid
                s.add_instance(s.add_segment(box), np.eye(4, dtype=np.float32))
    elif kind in ("arkmsh_binary", "arkmsh_json"):
        src = tree["box" if kind == "arkmsh_binary" else "sphere"]
        rt, rj = tark.load_arkmsh(ts, src), jark.load_arkmsh(js, src)
        for s, ids in ((ts, rt), (js, rj)):
            for sid in ids:
                s.add_instance(sid, np.eye(4, dtype=np.float32))
    elif kind == "arkset":
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (0.5, 0.0, -1.0)
        rt = tark.load_arkset(ts, tree["set"], root_transform=w)
        rj = jark.load_arkset(js, tree["set"], root_transform=w)
    else:
        src = tree["level"]
        if kind == "arklvl_binary":
            src = tmp_path / "assets" / "level_bin.arklvl"
            tcb.write_ark_binary(src, tark.read_ark_document(tree["level"], "level"))
        rt, rj = tark.load_arklvl(ts, src), jark.load_arklvl(js, src)
    return ts, js, rt, rj


@pytest.mark.parametrize("kind", ["arkmat", "arkmsh_binary", "arkmsh_json", "arkset", "arklvl",
                                  "arklvl_binary"])
def test_loaded_scene_matches_reference(kind, tree):
    tmp = Path(tree["level"]).parents[1]
    ts, js, rt, rj = load_both(kind, tree, tmp)
    if kind.startswith("arklvl"):
        for key in ("instances", "missing", "lights", "env"):
            assert rt[key] == rj[key], key
        assert rt["env"] and rt["lights"] == 3 and rt["instances"] == 6
        assert len(rt["cameras"]) == len(rj["cameras"]) == 1
        for f in ("position", "orientation", "focal_length_mm", "f_number", "iso",
                  "shutter_speed", "focus_depth", "near"):
            np.testing.assert_allclose(getattr(rt["cameras"][0], f),
                                       getattr(rj["cameras"][0], f), rtol=1e-6, err_msg=f)
        assert ts.static_info().has_translucent and len(ts.spots) == len(ts.points) == 1
    elif kind == "arkset":
        assert {k: rt[k] for k in ("instances", "nodes", "missing", "instance_ids")} == \
            {k: rj[k] for k in ("instances", "nodes", "missing", "instance_ids")}
    else:
        assert rt == rj
    assert len(ts.materials) == len(js.materials)
    assert len(ts.images) == len(js.texture_builder.images)
    ref = bridge.numpy_fields(js.build())
    ours = ts.build_host()
    assert set(ours) <= set(ref) and ours["tri_valid"].any()
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])


def test_arkmsh_without_normals_gets_flat_normals(tree):
    ts, _ = scenes()
    (sid,) = tark.load_arkmsh(ts, tree["sphere"])
    seg = ts.segments[sid]
    # Unit normals, but at the poles, whose triangles collapse to zero area.
    length = np.linalg.norm(seg.normals, axis=-1)
    assert seg.name == "sphere" and np.isclose(length, 1.0).mean() > 0.9


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_skeleton_and_animation_round_trip_drive_equal_poses(writer, tmp_path):
    """.arkskel and .arkanim written by ``writer``'s package, JSON and
    binary, read by both: equal skeletons, clips and poses at four times."""
    from arkoserenderer_torch.scene import animation as tanim
    from arkoserenderer_tpu.scene import animation as janim

    mod, anim = (tark, tanim) if writer == "torch" else (jark, janim)
    names = ["hip", "knee", "ankle", "toe"]
    mod.save_arkskel(tmp_path / "s.arkskel", _skeleton(anim), names)
    mod.save_arkanim(tmp_path / "a.arkanim", _clip(anim), names)
    for ext, key in ((".arkskel", "skeleton"), (".arkanim", "animation")):
        assert (tmp_path / f"s{ext}" if ext == ".arkskel" else tmp_path / f"a{ext}").exists()
    tcb.write_ark_binary(tmp_path / "sb.arkskel",
                         tark.read_ark_document(tmp_path / "s.arkskel", "skeleton"))
    tcb.write_ark_binary(tmp_path / "ab.arkanim",
                         tark.read_ark_document(tmp_path / "a.arkanim", "animation"))
    for skel_file, anim_file in (("s.arkskel", "a.arkanim"), ("sb.arkskel", "ab.arkanim")):
        tskel, tnames = tark.load_arkskel(tmp_path / skel_file)
        jskel, jnames = jark.load_arkskel(tmp_path / skel_file)
        assert tnames == jnames == names
        tclip = tark.load_arkanim(tmp_path / anim_file, tnames)
        jclip = jark.load_arkanim(tmp_path / anim_file, jnames)
        assert tclip.name == jclip.name == "wave"
        for t in (0.0, 0.25, 0.7, 1.3):
            tp, _ = tanim.evaluate_pose(tskel, tclip, t)
            jp, _ = janim.evaluate_pose(jskel, jclip, t)
            np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6)
        assert not np.allclose(tanim.evaluate_pose(tskel, tclip, 0.25)[0],
                               tanim.evaluate_pose(tskel, None, 0.0)[0])


def test_level_document_edit_sync_and_write(tree, tmp_path):
    """Both packages load the level, move the second object's first
    instance the same way, fold it back (``sync_from_scene``) and write:
    the same file; the port reads it back with the moved transform."""
    docs = {}
    for pkg, mod in (("torch", tark), ("jax", jark)):
        ts, js = scenes()
        scene = ts if pkg == "torch" else js
        res = mod.load_arklvl(scene, tree["level"])
        doc = res["doc"]
        inst = doc.object_instances[1][0]
        entry = list(scene.instances[inst])
        w = np.array(entry[1], np.float32)
        w[:3, 3] += (0.25, 1.0, -0.5)
        entry[1] = w
        scene.instances[inst] = tuple(entry)
        assert doc.sync_from_scene(scene) == 4
        doc.set_object_transform(0, (0.0, -0.6, 0.0), (0, 0, 0, 1), (12.0, 0.05, 12.0))
        out = tmp_path / f"{pkg}.arklvl"
        doc.write(out)
        docs[pkg] = json.loads(out.read_text())
    assert docs["torch"] == docs["jax"]
    back = tark.LevelDocument.read(tmp_path / "torch.arklvl")
    t = back.level["objects"][1]["transform"]["translation"]
    np.testing.assert_allclose([t["x"], t["y"], t["z"]], [-0.75, 1.0, -0.5], atol=1e-6)


def test_hair_raises_naming_hair_and_writes_the_reference_file(tree, tmp_path):
    """.arkhair: the port writes the reference's file; loading it, and a
    level object naming it, gives the reference's scene (hair is ported
    since: the load no longer raises), every build array equal."""
    rng = np.random.default_rng(1)
    pts, segs = rng.normal(size=(10, 3)).astype(np.float32), np.array([4, 4])
    tark.save_arkhair(tmp_path / "t.arkhair", pts, segs, thickness=0.02)
    jark.save_arkhair(tmp_path / "j.arkhair", pts, segs, thickness=0.02)
    assert (tmp_path / "t.arkhair").read_bytes() == (tmp_path / "j.arkhair").read_bytes()
    ts, js = scenes()
    assert tark.load_arkhair(ts, tmp_path / "t.arkhair") == jark.load_arkhair(
        js, tmp_path / "t.arkhair")
    assert ts.static_info().has_hair
    doc = json.loads(Path(tree["level"]).read_text())
    doc["level"]["objects"][1]["hair"] = "assets/strands.arkhair"
    (Path(tree["level"]).parent / "strands.arkhair").write_bytes(
        (tmp_path / "t.arkhair").read_bytes())
    level = Path(tree["level"]).with_name("hairy.arklvl")
    level.write_text(json.dumps(doc))
    ts, js = scenes()
    assert tark.load_arklvl(ts, level)["missing"] == jark.load_arklvl(js, level)["missing"]
    ours, ref = ts.build_host(), bridge.numpy_fields(js.build())
    assert ts.static_info().hair_vertex_base == js.static_info().hair_vertex_base > 0
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    level.unlink()
    (Path(tree["level"]).parent / "strands.arkhair").unlink()


def test_missing_and_corrupt_references_warn_and_skip(tree, tmp_path):
    """A mesh the level names but the tree lacks is skipped and listed, as
    in the reference; a DDS that does not decode keeps the default sky and
    logs a warning (the one caught error of the loader)."""
    from arkoserenderer_torch.core import logging as tlog

    root = tmp_path / "copy"
    paths = write_level(root)
    doc = json.loads(paths["level"].read_text())
    doc["level"]["objects"].append({"name": "ghost", "transform": {},
                                    "mesh": {"index": 0, "data": "assets/mesh/ghost.arkmsh"},
                                    "set": "", "hair": ""})
    paths["level"].write_text(json.dumps(doc))
    paths["sky"].write_bytes(b"DDS " + b"\0" * 40)
    warnings = tlog.warning_count()
    ts, js = scenes()
    rt, rj = tark.load_arklvl(ts, paths["level"]), jark.load_arklvl(js, paths["level"])
    assert rt["missing"] == rj["missing"] == ["assets/mesh/ghost.arkmsh"]
    assert rt["env"] is rj["env"] is False
    assert tlog.warning_count() >= warnings + 2
