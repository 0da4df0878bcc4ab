"""Native .ark* asset loading (port of arkoserenderer_tpu/assets/ark.py, on
the port's Scene, lights, Camera, Skeleton and AnimationClip).

The reference serializes its assets with cereal archives —
MeshAsset.h:147 (`.arkmsh`), MaterialAsset (`.arkmat`), LevelAsset
(`.arklvl`), SetAsset (`.arkset`) — in two storage flavors (Asset.h:15-18):
the JSON archive (name-value pairs, `cereal_class_version` markers,
`{"nullopt": ...}` for std::optional) that its shipped samples use, and the
Binary archive (4-char magic + raw cereal stream) that its bake pipeline
writes (tools/ArkAssetBakeTool.cpp:35-59). Every loader here sniffs the
magic and accepts EITHER flavor (`read_ark_document`; binary codec in
assets/cereal_binary.py; `tools/arkbake.py` is the bake-tool analogue), so
existing reference content — sample JSON or production-baked Binary —
works without re-export:

  * .arkmat — MaterialAsset.h:95-190: colorTint, metallic/roughness
    factors, blend mode (Opaque | Masked | Translucent), mask cutoff,
    double-sided, optional texture refs (baseColor/emissiveColor/
    normalMap/materialProperties image paths).
  * .arkmsh — MeshAsset.h: LODs -> meshSegments with positions /
    texcoord0s / normals / tangents / jointIndices / jointWeights /
    indices + a material asset path per segment.
  * .arklvl — LevelAsset: objects (TRS transform + mesh/set/hair asset
    refs), lights, cameras (physical-camera parameters matching
    scene/camera.py's f-number/ISO/shutter model), optional environment
    map + probe grid. LevelDocument supports edit + SAVE round-trips
    (LevelAsset::writeToFile analogue).
  * .arkset — SetAsset.h:9-36: node hierarchy (name/transform/meshIndex/
    children) over a meshAssets path table; transforms compose down the
    tree.
  * .arkskel — SkeletonAsset.h:29: recursive joint tree (name/index/
    transform/invBindMatrix) -> runtime Skeleton.
  * .arkanim — AnimationAsset.h:39-65: shared inputTracks + typed
    float/float2/float3/float4 channels (Linear/Step/CubicSpline),
    name-bound targets -> runtime AnimationClip.
  * .arkhair — HairAsset.h:17: strand points + 0xFFFFFFFF-reset line-strip
    indices, per-point thickness -> ``Scene.add_hair`` strands (a level
    object that names a hair asset loads it too).

Writers (save_arkset/save_arkskel/save_arkanim/save_arkhair +
LevelDocument.write) emit the same cereal-JSON dialect; formats with no
shipped samples in the reference checkout are pinned by write->load
round-trip tests.

Asset paths inside the files are relative to the assets ROOT (the
directory containing the leading "assets/..." component), resolved by
walking up from the referencing file.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from arkoserenderer_torch.core.logging import get_logger
from arkoserenderer_torch.scene.scene import (
    BLEND_MASKED,
    BLEND_OPAQUE,
    BLEND_TRANSLUCENT,
    Material,
    MeshSegment,
)

log = get_logger("ark")

_BLEND = {
    "Opaque": BLEND_OPAQUE,
    "Masked": BLEND_MASKED,
    "Translucent": BLEND_TRANSLUCENT,
}


def _vec(d, *keys):
    return np.array([d[k] for k in keys], np.float32)


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate the float32 vector ``v`` by the unit quaternion ``q`` (x, y,
    z, w): v + 2w (q_v x v) + q_v x (2 q_v x v)."""
    qv, qw = q[:3], q[3]
    t = 2.0 * np.cross(qv, v)
    return (v + qw * t + np.cross(qv, t)).astype(np.float32)


def _opt(d):
    """cereal std::optional: {"nullopt": true} or {"nullopt": false,
    "data": ...}; plain values pass through."""
    if isinstance(d, dict) and "nullopt" in d:
        return None if d["nullopt"] else d.get("data")
    return d


def _vec_array(seq, comps: str = "xyz", dtype=np.float32):
    """An array of cereal vecs: the JSON flavor gives a list of
    {"x","y","z"} dicts, the binary flavor (cereal_binary) an (n, k)
    numpy array. Returns None for empty/missing."""
    if seq is None:
        return None
    if isinstance(seq, np.ndarray):
        return seq.astype(dtype, copy=False) if len(seq) else None
    if len(seq) == 0:
        return None
    return np.array([[v[c] for c in comps] for v in seq], dtype)


def read_ark_document(path: Path, json_key: str) -> dict:
    """Load an .ark* file in either storage flavor, mirroring the
    reference's readFromFile logic (MeshAsset.cpp:849-886): sniff the
    4-char magic header (Asset.h:76-99) for the bake tools' Binary flavor
    (ArkAssetBakeTool.cpp:35-59), else parse the cereal-JSON flavor and
    unwrap its {json_key: {...}} nvp."""
    from arkoserenderer_torch.assets import cereal_binary

    data = Path(path).read_bytes()
    if cereal_binary.sniff_binary(data) is not None:
        return cereal_binary.decode(data)
    d = json.loads(data.decode("utf-8"))
    return d.get(json_key, d)


def find_assets_root(path: Path) -> Path:
    """Walk up until the directory that CONTAINS the "assets/" prefix used
    by in-file asset paths."""
    p = Path(path).resolve()
    for parent in p.parents:
        if (parent / "assets").is_dir() and parent.name != "assets":
            return parent
        if parent.name == "assets" and parent.parent.name == "assets":
            return parent.parent.parent
    return p.parent


def _resolve(root: Path, ref: str) -> Path | None:
    if not ref:
        return None
    cand = root / ref
    if cand.exists():
        return cand
    # Some refs are relative to the referencing file's directory instead.
    return None


def load_arkmat(scene, path: Path, max_texture_size: int | None = None) -> int:
    """.arkmat -> scene material id (MaterialAsset.h:95-190 field set)."""
    path = Path(path)
    doc = read_ark_document(path, "material")
    root = find_assets_root(path)

    def tex_of(slot, srgb):
        ref = _opt(doc.get(slot))
        if ref is None:
            return None
        img_path = ref.get("image") if isinstance(ref, dict) else ref
        p = _resolve(root, img_path) if isinstance(img_path, str) else None
        if p is None:
            log.warning("%s: %s image %r not found", path.name, slot, img_path)
            return None
        from arkoserenderer_torch.utils.imageio import load_image_rgba

        img = load_image_rgba(str(p))
        if max_texture_size and max(img.shape[:2]) > max_texture_size:
            from arkoserenderer_torch.ops.mattex import _np_resize_bilinear

            s = max_texture_size / max(img.shape[:2])
            img = _np_resize_bilinear(
                img, max(int(img.shape[1] * s), 1), max(int(img.shape[0] * s), 1)
            ).astype(np.uint8)
        return scene.add_texture(img, srgb=srgb)

    kw = {}
    base_tex = tex_of("baseColor", srgb=True)
    if base_tex is not None:
        kw["base_color_tex"] = base_tex
    nrm_tex = tex_of("normalMap", srgb=False)
    if nrm_tex is not None:
        kw["normal_tex"] = nrm_tex
    mr_tex = tex_of("materialProperties", srgb=False)
    if mr_tex is not None:
        kw["mr_tex"] = mr_tex
    emi_tex = tex_of("emissiveColor", srgb=True)
    if emi_tex is not None:
        kw["emissive_tex"] = emi_tex

    mat = Material(
        base_color_factor=_vec(doc["colorTint"], "x", "y", "z", "w"),
        metallic_factor=float(doc.get("metallicFactor", 0.0)),
        roughness_factor=float(doc.get("roughnessFactor", 1.0)),
        blend_mode=_BLEND.get(doc.get("blendMode", "Opaque"), BLEND_OPAQUE),
        alpha_cutoff=float(doc.get("maskCutoff", 0.5)),
        double_sided=bool(doc.get("doubleSided", False)),
        **kw,
    )
    return scene.add_material(mat)


def load_arkmsh(scene, path: Path, lod: int = 0,
                max_texture_size: int | None = None) -> list[int]:
    """.arkmsh -> list of scene segment ids for one LOD (MeshAsset.h's
    LODs[lod].meshSegments). Materials referenced per segment load through
    load_arkmat (cached per path)."""
    path = Path(path)
    doc = read_ark_document(path, "mesh")
    root = find_assets_root(path)
    lods = doc.get("LODs", [])
    if not lods:
        return []
    lod = min(lod, len(lods) - 1)
    mat_cache: dict = {}
    seg_ids = []
    for seg in lods[lod].get("meshSegments", []):
        pos = _vec_array(seg["positions"], "xyz")
        nrm = _vec_array(seg.get("normals"), "xyz")
        uv = _vec_array(seg.get("texcoord0s"), "xy")
        tan = _vec_array(seg.get("tangents"), "xyzw")
        idx = np.asarray(seg["indices"]).astype(np.int32)
        mat_ref = seg.get("material", "")
        mat_id = 0
        if mat_ref:
            if mat_ref not in mat_cache:
                p = _resolve(root, mat_ref) or (path.parent / Path(mat_ref).name)
                if p is not None and Path(p).exists():
                    mat_cache[mat_ref] = load_arkmat(
                        scene, p, max_texture_size=max_texture_size
                    )
                else:
                    log.warning("%s: material %r not found", path.name, mat_ref)
                    mat_cache[mat_ref] = 0
            mat_id = mat_cache[mat_ref]
        if nrm is None:
            # Flat normals from triangle winding.
            nrm = np.zeros_like(pos)
            tri = idx.reshape(-1, 3)
            fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]],
                          pos[tri[:, 2]] - pos[tri[:, 0]])
            for k in range(3):
                np.add.at(nrm, tri[:, k], fn)
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-8)
        ms = MeshSegment(
            positions=pos, normals=nrm, uvs=uv, tangents=tan, indices=idx,
            material=mat_id, name=doc.get("name", path.stem),
        )
        seg_ids.append(scene.add_segment(ms))
    return seg_ids


def _trs_matrix(t: dict) -> np.ndarray:
    """cereal Transform {translation, orientation, scale} -> 4x4."""
    from arkoserenderer_torch.core import mathx as mx

    q = _vec(t.get("orientation", dict(x=0, y=0, z=0, w=1)), "x", "y", "z", "w")
    q = q / max(np.linalg.norm(q), 1e-8)
    r3 = np.asarray(mx.quat_to_mat3(q), np.float32)
    s = _vec(t.get("scale", dict(x=1, y=1, z=1)), "x", "y", "z")
    w = np.eye(4, dtype=np.float32)
    w[:3, :3] = r3 * s[None, :]
    w[:3, 3] = _vec(t.get("translation", dict(x=0, y=0, z=0)), "x", "y", "z")
    return w


def _trs_json(translation, orientation, scale) -> dict:
    return {
        "translation": _vec_json(translation),
        "orientation": _vec_json(orientation, "xyzw"),
        "scale": _vec_json(scale),
    }


def _vec_json(v, comps: str = "xyz") -> dict:
    v = np.asarray(v, np.float64)
    return {c: float(v[i]) for i, c in enumerate(comps)}


def _decompose_matrix(w: np.ndarray):
    """4x4 -> (translation, quat xyzw, scale); assumes no shear (the editor
    gizmo and level transforms only produce TRS, Transform.h semantics)."""
    from arkoserenderer_torch.core import mathx as mx

    w = np.asarray(w, np.float64)
    t = w[:3, 3].astype(np.float32)
    s = np.linalg.norm(w[:3, :3], axis=0)
    if np.linalg.det(w[:3, :3]) < 0:  # mirrored: fold the sign into X
        s = s * np.array([-1.0, 1.0, 1.0])
    r3 = w[:3, :3] / np.maximum(np.abs(s), 1e-12)[None, :] * np.sign(s)[None, :]
    q = np.asarray(mx.quat_from_mat3(r3.astype(np.float32)), np.float32)
    return t, q / max(np.linalg.norm(q), 1e-8), s.astype(np.float32)


class LevelDocument:
    """A parsed .arklvl with save support (LevelAsset.h:135 analogue).

    Wraps the raw cereal-JSON dict so load -> edit -> save round-trips
    without dropping fields this runtime doesn't consume. ``instantiate``
    populates a Scene and records which scene instances every level object
    produced, so ``sync_from_scene`` can fold editor transform edits back
    into the document before ``write``.
    """

    def __init__(self, doc: dict, path: Path | None = None):
        self.doc = doc
        self.path = Path(path) if path else None
        # per level-object list of scene instance ids (filled by instantiate)
        self.object_instances: list[list[int]] = []

    @classmethod
    def read(cls, path: Path) -> "LevelDocument":
        path = Path(path)
        doc = read_ark_document(path, "level")
        return cls(doc if "level" in doc else {"level": doc}, path)

    @property
    def level(self) -> dict:
        return self.doc["level"]

    # -- save ------------------------------------------------------------
    def write(self, path: Path) -> None:
        """Serialize back to cereal-JSON (4-space indent, the archive's
        formatting) — LevelAsset::writeToFile analogue."""
        Path(path).write_text(json.dumps(self.doc, indent=4) + "\n")

    def set_object_transform(self, index: int, translation, orientation,
                             scale) -> None:
        self.level["objects"][index]["transform"] = _trs_json(
            translation, orientation, scale)

    def sync_from_scene(self, scene) -> int:
        """Copy each instantiated object's CURRENT scene transform (e.g.
        after editor gizmo edits) back into the document. Returns the number
        of objects updated."""
        n = 0
        for i, inst_ids in enumerate(self.object_instances):
            if not inst_ids:
                continue
            w = scene.instance_transform(inst_ids[0])
            t, q, s = _decompose_matrix(w)
            self.set_object_transform(i, t, q, s)
            n += 1
        return n

    # -- instantiate -----------------------------------------------------
    def instantiate(self, scene, max_texture_size: int | None = None) -> dict:
        root = find_assets_root(self.path) if self.path else Path(".")
        doc = self.level
        n_inst = 0
        missing: list[str] = []
        msh_cache: dict = {}
        self.object_instances = []
        for obj in doc.get("objects", []):
            inst_ids: list[int] = []
            w = _trs_matrix(obj["transform"])
            mesh_ref = obj.get("mesh")
            ref_path = (
                (mesh_ref or {}).get("data", "")
                if isinstance(mesh_ref, dict) else (mesh_ref or "")
            )
            if isinstance(ref_path, str) and ref_path:
                if ref_path not in msh_cache:
                    p = _resolve(root, ref_path)
                    if p is None:
                        log.warning("%s: mesh %r not found",
                                    self.path and self.path.name, ref_path)
                        missing.append(ref_path)
                        msh_cache[ref_path] = None
                    else:
                        msh_cache[ref_path] = load_arkmsh(
                            scene, p, max_texture_size=max_texture_size
                        )
                for sid in msh_cache[ref_path] or ():
                    inst_ids.append(scene.add_instance(sid, w))
                    n_inst += 1
            set_ref = obj.get("set", "")
            if set_ref:
                p = _resolve(root, set_ref)
                if p is None:
                    log.warning("%s: set %r not found",
                                self.path and self.path.name, set_ref)
                    missing.append(set_ref)
                else:
                    info = load_arkset(scene, p, root_transform=w,
                                       max_texture_size=max_texture_size)
                    inst_ids.extend(info["instance_ids"])
                    n_inst += info["instances"]
                    missing.extend(info["missing"])
            hair_ref = obj.get("hair", "")
            if hair_ref:
                p = _resolve(root, hair_ref)
                if p is None:
                    log.warning("%s: hair %r not found",
                                self.path and self.path.name, hair_ref)
                    missing.append(hair_ref)
                else:
                    load_arkhair(scene, p, transform=w)
            self.object_instances.append(inst_ids)
        return {"instances": n_inst, "missing": missing}


def load_arklvl(scene, path: Path, max_texture_size: int | None = None) -> dict:
    """.arklvl -> instances + camera + environment into the Scene
    (LevelAsset: objects with TRS transforms referencing .arkmsh/.arkset/
    .arkhair assets).

    Returns {"instances": n, "cameras": [Camera...], "missing": [refs],
    "doc": LevelDocument} — missing asset refs are skipped with a warning
    (several shipped levels reference meshes not present in the reference
    checkout); the LevelDocument supports transform edits + save.
    """
    from arkoserenderer_torch.scene.camera import Camera

    path = Path(path)
    level_doc = LevelDocument.read(path)
    obj_info = level_doc.instantiate(scene, max_texture_size=max_texture_size)
    doc = level_doc.level
    root = find_assets_root(path)
    n_inst = obj_info["instances"]
    missing = obj_info["missing"]

    # Lights: cereal variant {"index": N, "data": {...}} per type; the
    # light's direction is its transform's forward = orientation * -Z
    # (arklib globalForward, Transform.h:56).
    from arkoserenderer_torch.scene.lights import (
        DirectionalLight,
        PointLight,
        SpotLight,
    )

    n_lights = 0
    for li in doc.get("lights", []):
        t = li.get("transform", {})
        q = _vec(t.get("orientation", dict(x=0, y=0, z=0, w=1)),
                 "x", "y", "z", "w")
        q = q / max(np.linalg.norm(q), 1e-8)   # files ship unnormalized quats
        fwd = _quat_rotate(q, np.array([0.0, 0.0, -1.0], np.float32))
        pos = _vec(t.get("translation", dict(x=0, y=0, z=0)), "x", "y", "z")
        color = _vec(li.get("color", dict(x=1, y=1, z=1)), "x", "y", "z")
        data = li.get("data", {})
        params = data.get("data", {}) if isinstance(data, dict) else {}
        kind = li.get("type", "")
        casts = bool(li.get("castsShadows", True))
        if kind == "DirectionalLight":
            scene.sun = DirectionalLight(
                direction=fwd, color=color,
                illuminance_lux=float(params.get("illuminance", 90000.0)),
            )
            n_lights += 1
        elif kind == "SpotLight":
            scene.spots.append(SpotLight(
                position=pos, direction=fwd, color=color,
                luminous_intensity_cd=float(
                    params.get("luminousIntensity", 1000.0)),
                outer_cone_angle=float(params.get("outerConeAngle", 0.5)),
                inner_cone_angle=float(
                    params.get("innerConeAngle",
                               params.get("outerConeAngle", 0.5) * 0.66)),
                cast_shadows=casts,
            ))
            n_lights += 1
        elif kind in ("PointLight", "SphereLight"):
            scene.points.append(PointLight(
                position=pos, color=color,
                luminous_intensity_cd=float(
                    params.get("luminousIntensity", 1000.0)),
                cast_shadows=casts,
            ))
            n_lights += 1
        elif kind:
            log.warning("%s: unsupported light type %r", path.name, kind)

    cameras = []
    for c in doc.get("cameras", []):
        cam = Camera()
        cam.position = _vec(c["position"], "x", "y", "z")
        q = _vec(c["orientation"], "x", "y", "z", "w")
        cam.orientation = q
        cam.focal_length_mm = float(c.get("focalLength", 30.0))
        cam.f_number = float(c.get("fNumber", 16.0))
        cam.iso = float(c.get("iso", 400.0))
        cam.shutter_speed = float(c.get("shutterSpeed", 1.0 / 400.0))
        cam.focus_depth = float(c.get("focusDepth", 5.0))
        cam.near = float(c.get("nearClipPlane", 0.25))
        cameras.append(cam)

    env_set = False
    env = _opt(doc.get("environmentMap"))
    if env and isinstance(env, dict):
        p = _resolve(root, env.get("assetPath", ""))
        if p is not None:
            from arkoserenderer_torch.assets.external import DDSImage

            try:
                dds = DDSImage.parse(Path(p).read_bytes())
                img = dds.mips[0].astype(np.float32) / 255.0
                scene.set_env_map(
                    img[..., :3], brightness=float(env.get("brightnessFactor", 1.0))
                )
                env_set = True
            except Exception as e:  # corrupt/unsupported codec: keep default
                log.warning("%s: env map %s failed to load: %s", path.name, p, e)
        else:
            log.warning("%s: env map %r not found",
                        path.name, env.get("assetPath"))

    return {"instances": n_inst, "cameras": cameras, "missing": missing,
            "doc": level_doc,
            "lights": n_lights, "env": env_set}


# ---------------------------------------------------------------------------
# SetAsset (.arkset): node hierarchy referencing a mesh-asset table
# ---------------------------------------------------------------------------

def load_arkset(scene, path: Path, root_transform: np.ndarray | None = None,
                max_texture_size: int | None = None) -> dict:
    """.arkset -> instances into the Scene (SetAsset.h:9-36: a rootNode tree
    of {name, transform, meshIndex, children} plus a meshAssets path table).

    Node transforms compose down the hierarchy (parents are never serialized
    — Transform.h:210 — so world transforms are reconstructed here);
    ``root_transform`` premultiplies everything (the owning level object's
    transform when a level instantiates a set).

    Returns {"instances", "nodes", "instance_ids", "missing"}.
    """
    path = Path(path)
    doc = read_ark_document(path, "set")
    root = find_assets_root(path)
    mesh_assets = doc.get("meshAssets", [])
    msh_cache: dict = {}
    missing: list[str] = []
    instance_ids: list[int] = []
    n_nodes = 0

    def segs_for(mesh_index: int):
        if not (0 <= mesh_index < len(mesh_assets)):
            return None
        ref = mesh_assets[mesh_index]
        if ref not in msh_cache:
            p = _resolve(root, ref)
            if p is None:
                log.warning("%s: mesh %r not found", path.name, ref)
                missing.append(ref)
                msh_cache[ref] = None
            else:
                msh_cache[ref] = load_arkmsh(
                    scene, p, max_texture_size=max_texture_size)
        return msh_cache[ref]

    def walk(node: dict, parent_world: np.ndarray):
        nonlocal n_nodes
        n_nodes += 1
        world = parent_world @ _trs_matrix(node.get("transform", {}))
        mesh_index = int(node.get("meshIndex", -1))
        if mesh_index >= 0:
            for sid in segs_for(mesh_index) or ():
                instance_ids.append(scene.add_instance(sid, world))
        for child in node.get("children", []):
            # cereal serializes vector<unique_ptr<T>> entries as
            # {"ptr_wrapper": {"valid": 1, "data": {...}}} polymorphic-free
            # wrappers; unwrap if present.
            c = child
            if isinstance(c, dict) and "ptr_wrapper" in c:
                c = c["ptr_wrapper"].get("data", {})
            walk(c, world)

    base = np.eye(4, dtype=np.float32) if root_transform is None else root_transform
    walk(doc.get("rootNode", {}), np.asarray(base, np.float32))
    return {"instances": len(instance_ids), "nodes": n_nodes,
            "instance_ids": instance_ids, "missing": missing}


def save_arkset(path: Path, root_node: dict, mesh_assets: list[str],
                name: str = "") -> None:
    """Write a SetAsset as cereal-JSON. ``root_node`` uses the same dict
    shape load_arkset reads: {name, transform: {translation/orientation/
    scale}, meshIndex, lightIndex, cameraIndex, children: [...]}; missing
    keys get defaults."""

    def norm(node: dict) -> dict:
        t = node.get("transform", {})
        out = {
            "cereal_class_version": 0,
            "name": node.get("name", ""),
            "transform": {
                "translation": t.get("translation", _vec_json((0, 0, 0))),
                "orientation": t.get("orientation", _vec_json((0, 0, 0, 1), "xyzw")),
                "scale": t.get("scale", _vec_json((1, 1, 1))),
            },
            "meshIndex": int(node.get("meshIndex", -1)),
            "lightIndex": int(node.get("lightIndex", -1)),
            "cameraIndex": int(node.get("cameraIndex", -1)),
            "children": [norm(c) for c in node.get("children", [])],
        }
        return out

    doc = {"set": {
        "cereal_class_version": 0,
        "name": name,
        "rootNode": norm(root_node),
        "meshAssets": list(mesh_assets),
    }}
    Path(path).write_text(json.dumps(doc, indent=4) + "\n")


# ---------------------------------------------------------------------------
# SkeletonAsset (.arkskel): recursive joint tree -> runtime Skeleton
# ---------------------------------------------------------------------------

def _mat4_from_json(m: dict) -> np.ndarray:
    """arklib mat4 cereal form: columns x/y/z/w, each a vec4 {x,y,z,w}
    (SerialisationHelpers.h mat4 serialize)."""
    cols = [ [m[c]["x"], m[c]["y"], m[c]["z"], m[c]["w"]] for c in "xyzw" ]
    return np.array(cols, np.float32).T  # columns -> (4,4) row-major


def _mat4_json(m: np.ndarray) -> dict:
    m = np.asarray(m, np.float64)
    return {c: {"x": float(m[0, i]), "y": float(m[1, i]),
                "z": float(m[2, i]), "w": float(m[3, i])}
            for i, c in enumerate("xyzw")}


def load_arkskel(path: Path):
    """.arkskel -> (Skeleton, joint_names: list[str]).

    SkeletonAsset.h:29: a rootJoint tree of SkeletonJointAsset {name, index,
    transform, invBindMatrix, children} + maxJointIdx. Joint ``index`` is
    the id vertices reference (jointIndices in .arkmsh), so the runtime
    arrays are laid out in asset-index order; evaluate_pose needs parents
    before children, which holds for any tree serialized depth-first —
    asserted here, remapped via topo_sort_joints otherwise.
    """
    from arkoserenderer_torch.scene.animation import Skeleton, topo_sort_joints

    path = Path(path)
    doc = read_ark_document(path, "skeleton")
    n = int(doc.get("maxJointIdx", 0)) + 1
    parents = np.full(n, -1, np.int32)
    inv_bind = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rest_t = np.zeros((n, 3), np.float32)
    rest_r = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    rest_s = np.ones((n, 3), np.float32)
    names = [""] * n

    def walk(joint: dict, parent_idx: int):
        i = int(joint.get("index", 0))
        assert 0 <= i < n, f"joint index {i} out of range (maxJointIdx {n - 1})"
        parents[i] = parent_idx
        names[i] = joint.get("name", "")
        t = joint.get("transform", {})
        rest_t[i] = _vec(t.get("translation", dict(x=0, y=0, z=0)), "x", "y", "z")
        q = _vec(t.get("orientation", dict(x=0, y=0, z=0, w=1)), "x", "y", "z", "w")
        rest_r[i] = q / max(np.linalg.norm(q), 1e-8)
        rest_s[i] = _vec(t.get("scale", dict(x=1, y=1, z=1)), "x", "y", "z")
        if "invBindMatrix" in joint:
            inv_bind[i] = _mat4_from_json(joint["invBindMatrix"])
        for child in joint.get("children", []):
            walk(child, i)

    walk(doc.get("rootJoint", {}), -1)
    skel = Skeleton(parents=parents, inverse_bind=inv_bind,
                    rest_translation=rest_t, rest_rotation=rest_r,
                    rest_scale=rest_s)
    if not np.all(parents < np.arange(n)):
        # Asset indices aren't topo-ordered: evaluate_pose would read stale
        # parent matrices. Keep asset-index layout (vertices reference it) —
        # reorder only the evaluation by sorting, then mapping back.
        order, remap = topo_sort_joints(parents)
        p_sorted = parents[order]
        new_parents = np.where(
            p_sorted >= 0, remap[np.maximum(p_sorted, 0)], -1
        ).astype(np.int32)
        skel = Skeleton(
            parents=new_parents,
            inverse_bind=inv_bind[order],
            rest_translation=rest_t[order], rest_rotation=rest_r[order],
            rest_scale=rest_s[order])
        names = [names[i] for i in order]
        log.warning("%s: joint indices not topologically ordered; "
                    "re-ordered (vertex joint ids must be remapped by the "
                    "caller via the returned name order)", path.name)
    return skel, names


def save_arkskel(path: Path, skeleton, names: list[str]) -> None:
    """Write a runtime Skeleton as a .arkskel (SkeletonAsset) cereal-JSON
    tree. Joint array order == asset joint ``index``."""
    n = skeleton.num_joints
    children: dict[int, list[int]] = {i: [] for i in range(-1, n)}
    for i, p in enumerate(np.asarray(skeleton.parents)):
        children[int(p)].append(i)

    def joint_json(i: int) -> dict:
        return {
            "cereal_class_version": 0,
            "name": names[i] if i < len(names) else f"joint{i}",
            "index": i,
            "transform": _trs_json(skeleton.rest_translation[i],
                                   skeleton.rest_rotation[i],
                                   skeleton.rest_scale[i]),
            "invBindMatrix": _mat4_json(skeleton.inverse_bind[i]),
            "children": [joint_json(c) for c in children[i]],
        }

    roots = children[-1]
    assert len(roots) == 1, "SkeletonAsset serializes exactly one rootJoint"
    doc = {"skeleton": {
        "cereal_class_version": 0,
        "rootJoint": joint_json(roots[0]),
        "maxJointIdx": n - 1,
    }}
    Path(path).write_text(json.dumps(doc, indent=4) + "\n")


# ---------------------------------------------------------------------------
# AnimationAsset (.arkanim): typed channels + shared input tracks
# ---------------------------------------------------------------------------

_ANIM_PROP = {"Translation": "translation", "Rotation": "rotation",
              "Scale": "scale", "Weights": "weights"}
_ANIM_PROP_REV = {v: k for k, v in _ANIM_PROP.items()}
_ANIM_INTERP = {"Linear": 1, "Step": 0, "CubicSpline": 2}
_ANIM_INTERP_REV = {v: k for k, v in _ANIM_INTERP.items()}


def load_arkanim(path: Path, joint_names: list[str] | None = None):
    """.arkanim -> runtime AnimationClip (AnimationAsset.h:39-65).

    Channels target joints BY NAME (``targetReference``); ``joint_names``
    (from load_arkskel) resolves them to indices. Unresolvable targets keep
    index -1 (morph-weight channels always do). Values per channel live in
    typed arrays (float/float2/float3/float4PropertyChannels) sampled along
    a shared ``inputTracks[inputTrackIdx]`` time track.
    """
    from arkoserenderer_torch.scene.animation import AnimationClip, AnimChannel

    path = Path(path)
    doc = read_ark_document(path, "animation")
    tracks = [np.asarray(t, np.float32) for t in doc.get("inputTracks", [])]
    name_to_idx = {nm: i for i, nm in enumerate(joint_names or []) if nm}
    channels = []
    groups = (("floatPropertyChannels", 1), ("float2PropertyChannels", 2),
              ("float3PropertyChannels", 3), ("float4PropertyChannels", 4))
    for key, width in groups:
        for ch in doc.get(key, []):
            sampler = ch.get("sampler", {})
            out = sampler.get("outputValues", [])
            if width == 1 or isinstance(out, np.ndarray):
                vals = np.asarray(out, np.float32).reshape(-1, width)
            else:
                comps = "xyzw"[:width]
                vals = np.array([[v[c] for c in comps] for v in out], np.float32)
            prop = _ANIM_PROP.get(ch.get("targetProperty", ""), "translation")
            target = ch.get("targetReference", "")
            channels.append(AnimChannel(
                target_joint=name_to_idx.get(target, -1),
                path=prop,
                times=tracks[int(sampler.get("inputTrackIdx", 0))],
                values=vals,
                interpolation=_ANIM_INTERP.get(
                    sampler.get("interpolation", "Linear"), 1),
            ))
    return AnimationClip(channels=channels, name=doc.get("name", path.stem))


def save_arkanim(path: Path, clip, joint_names: list[str]) -> None:
    """Write a runtime AnimationClip as a .arkanim (AnimationAsset). Time
    tracks are deduplicated into the shared inputTracks table; channels are
    routed to the typed array matching their component width."""
    tracks: list[np.ndarray] = []

    def track_idx(times: np.ndarray) -> int:
        for i, t in enumerate(tracks):
            if len(t) == len(times) and np.allclose(t, times):
                return i
        tracks.append(np.asarray(times, np.float32))
        return len(tracks) - 1

    groups: dict[int, list] = {1: [], 2: [], 3: [], 4: []}
    for ch in clip.channels:
        vals = np.asarray(ch.values, np.float32)
        width = 1 if vals.ndim == 1 else int(vals.shape[1])
        if width == 1:
            out = [float(v) for v in vals.reshape(-1)]
        else:
            comps = "xyzw"[:width]
            out = [{c: float(v[k]) for k, c in enumerate(comps)} for v in vals]
        target = ""
        if 0 <= ch.target_joint < len(joint_names):
            target = joint_names[ch.target_joint]
        groups[width].append({
            "cereal_class_version": 0,
            "targetReference": target,
            "targetProperty": _ANIM_PROP_REV[ch.path],
            "sampler": {
                "inputTrackIdx": track_idx(ch.times),
                "outputValues": out,
                "interpolation": _ANIM_INTERP_REV[ch.interpolation],
            },
        })
    doc = {"animation": {
        "cereal_class_version": 0,
        "name": clip.name,
        "inputTracks": [[float(x) for x in t] for t in tracks],
        "floatPropertyChannels": groups[1],
        "float2PropertyChannels": groups[2],
        "float3PropertyChannels": groups[3],
        "float4PropertyChannels": groups[4],
    }}
    Path(path).write_text(json.dumps(doc, indent=4) + "\n")


# ---------------------------------------------------------------------------
# HairAsset (.arkhair): strand points + line-strip indices
# ---------------------------------------------------------------------------

_HAIR_RESET = 0xFFFFFFFF


def load_arkhair(scene, path: Path, transform: np.ndarray | None = None,
                 material: int = 0) -> dict:
    """.arkhair -> hair strands into the Scene (HairAsset: positions and
    line-strip indices with 0xFFFFFFFF strand resets, per-point thickness,
    per-strand segment counts with scalar defaults). The points are
    gathered strand after strand (what ``Scene.add_hair`` takes);
    ``transform`` places them in the world; the radius is half the
    thickness. Returns {"strands", "points", "segment_id"}."""
    path = Path(path)
    doc = read_ark_document(path, "hair")
    raw_pos = _vec_array(doc.get("positions"), "xyz")
    if raw_pos is None:
        raw_pos = np.zeros((0, 3), np.float32)
    indices = np.asarray(doc.get("indices", []), np.int64)
    default_thickness = float(doc.get("defaultThickness", 1.0))
    thickness = np.asarray(doc.get("thickness", []), np.float32)

    # Split the index stream at the reset markers into strands.
    strands: list[np.ndarray] = []
    run: list[int] = []
    for ix in indices:
        if ix == _HAIR_RESET or ix == -1:
            if len(run) >= 2:
                strands.append(np.asarray(run, np.int64))
            run = []
        else:
            run.append(int(ix))
    if len(run) >= 2:
        strands.append(np.asarray(run, np.int64))
    if not strands and len(raw_pos):
        # No index stream: the segment counts partition the positions.
        raw_counts = doc.get("segmentCounts")
        if raw_counts is None or len(raw_counts) == 0:
            raw_counts = ([int(doc.get("defaultSegmentCount", 0))]
                          * int(doc.get("strandCount", 0)))
        start = 0
        for sc in np.asarray(raw_counts, np.int64):
            strands.append(np.arange(start, start + sc + 1, dtype=np.int64))
            start += sc + 1

    order = np.concatenate(strands) if strands else np.zeros(0, np.int64)
    points = raw_pos[order]
    if transform is not None:
        w = np.asarray(transform, np.float32)
        points = points @ w[:3, :3].T + w[:3, 3]
    segments = np.array([len(s) - 1 for s in strands], np.int32)
    radius = thickness[order] * 0.5 if len(thickness) else default_thickness * 0.5
    seg_id = scene.add_hair(points, segments, material=material, radius=radius)
    return {"strands": len(strands), "points": len(points), "segment_id": seg_id}


def save_arkhair(path: Path, points: np.ndarray, segments: np.ndarray,
                 thickness: np.ndarray | float = 1.0,
                 color=(1.0, 1.0, 1.0)) -> None:
    """Write strand geometry as a .arkhair (HairAsset): strand-consecutive
    ``points`` (P,3) + ``segments`` (S,) points-per-strand-1, per-point or
    scalar thickness."""
    points = np.asarray(points, np.float32)
    segments = np.asarray(segments, np.int64)
    indices: list[int] = []
    start = 0
    for sc in segments:
        n_pts = int(sc) + 1
        indices.extend(range(start, start + n_pts))
        indices.append(_HAIR_RESET)
        start += n_pts
    if indices:
        indices.pop()  # no trailing reset
    scalar_thick = np.isscalar(thickness)
    lo = points.min(axis=0) if len(points) else np.zeros(3)
    hi = points.max(axis=0) if len(points) else np.zeros(3)
    doc = {"hair": {
        "cereal_class_version": 0,
        "strandCount": int(len(segments)),
        "positions": [_vec_json(p) for p in points],
        "indices": [int(i) for i in indices],
        "defaultSegmentCount": int(segments[0]) if len(segments) else 0,
        "defaultThickness": float(thickness) if scalar_thick else 1.0,
        "defaultTransparency": 0.0,
        "defaultColor": _vec_json(color),
        "segmentCounts": [int(s) for s in segments],
        "thickness": [] if scalar_thick else [float(t) for t in np.asarray(thickness)],
        "transparency": [],
        "colors": [],
        "boundingBox": {"min": _vec_json(lo), "max": _vec_json(hi)},
    }}
    Path(path).write_text(json.dumps(doc, indent=4) + "\n")
