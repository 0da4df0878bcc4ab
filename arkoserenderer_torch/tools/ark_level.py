"""Write a small asset tree in the reference's own formats (.arkmsh,
.arkmat, .arkset, .arklvl, a BC7 .dds and a PNG) with the port's writers,
for the showcase app's level input and its tests.

    from arkoserenderer_torch.tools.ark_level import write_level
    paths = write_level(Path("some/dir"))   # -> {"level": .../level.arklvl, ...}
    python -m arkoserenderer_torch.apps.showcase --gltf some/dir/assets/level.arklvl

The tree, under ``root/assets/``:
  tex/albedo.png     32x32 RGBA checker (the opaque material's base colour)
  mat/opaque.arkmat  JSON: that PNG, a tint, metallic / roughness factors
  mat/glass.arkmat   cereal binary: translucent (blendMode Translucent,
                     alpha 0.45), double-sided
  mesh/box.arkmsh    cereal binary (``cereal_binary.write_ark_binary``):
                     ``procedural.make_box``, the opaque material
  mesh/sphere.arkmsh JSON: ``procedural.make_uv_sphere`` without normals
                     (the loader makes flat ones), the glass material
  set/pair.arkset    a two-level node tree instancing both meshes
  env/sky.dds        a 32x64 BC7 environment map (DX10 header)
  level.arklvl       JSON: a floor box, the box, the sphere in front of the
                     camera, the set, a directional light, a spot, a point
                     light, a camera and the environment map

Every array is made from one fixed seed; asset paths inside the files start with
"assets/", as the reference's do.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from arkoserenderer_torch.assets import bc7, cereal_binary
from arkoserenderer_torch.assets.ark import save_arkset
from arkoserenderer_torch.assets.procedural import make_box, make_uv_sphere
from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.utils.imageio import save_png


def _xyz(v, comps: str = "xyz") -> dict:
    return {c: float(x) for c, x in zip(comps, np.asarray(v, np.float64))}


def _trs(t=(0, 0, 0), q=(0, 0, 0, 1), s=(1, 1, 1)) -> dict:
    return {"translation": _xyz(t), "orientation": _xyz(q, "xyzw"), "scale": _xyz(s)}


def mesh_doc(seg, material: str, name: str, as_json: bool, normals: bool = True) -> dict:
    """A MeshAsset document of one segment: numpy arrays (the binary
    writer's fast path) or lists of {x, y, z} records (the JSON flavor)."""
    def rows(a, comps):
        a = np.asarray(a, np.float32)
        return [_xyz(r, comps) for r in a] if as_json else a

    lo, hi = seg.positions.min(0), seg.positions.max(0)
    center = (lo + hi) / 2
    idx = np.asarray(seg.indices, np.uint32)
    return {
        "name": name,
        "LODs": [{"meshSegments": [{
            "positions": rows(seg.positions, "xyz"),
            "texcoord0s": rows(seg.uvs, "xy"),
            "normals": rows(seg.normals, "xyz") if normals else [],
            "tangents": rows(seg.tangents, "xyzw"),
            "jointIndices": [] if as_json else np.zeros((0, 4), np.uint16),
            "jointWeights": [] if as_json else np.zeros((0, 4), np.float32),
            "morphTargets": [],
            "indices": [int(i) for i in idx] if as_json else idx,
            "meshletData": None,
            "opacityMicroMapData": None,
            "material": material,
        }]}],
        "minLOD": 0, "maxLOD": 99,
        "boundingBox": {"min": _xyz(lo), "max": _xyz(hi)},
        "boundingSphere": {"center": _xyz(center),
                           "radius": float(np.linalg.norm(hi - center))},
    }


def material_doc(tint, blend: str, base_image: str | None = None, metallic: float = 0.0,
                 roughness: float = 0.5, double_sided: bool = False) -> dict:
    """A MaterialAsset document (format version 6's fields)."""
    base = None
    if base_image is not None:
        base = {"image": base_image,
                "wrapModes": {"u": "Repeat", "v": "Repeat", "w": "Repeat"},
                "minFilter": "Linear", "magFilter": "Linear", "useMipmapping": True,
                "mipFilter": "Linear"}
    return {
        "brdf": "Default", "baseColor": base, "emissiveColor": None, "normalMap": None,
        "bentNormalMap": None, "materialProperties": None, "occlusionMap": None,
        "colorTint": _xyz(tint, "xyzw"), "metallicFactor": metallic,
        "roughnessFactor": roughness, "emissiveFactor": _xyz((0, 0, 0)),
        "clearcoat": 0.0, "clearcoatRoughness": 0.0, "indexOfRefraction": 1.5,
        "transmissionFactor": 0.0, "transmissionMap": None,
        "blendMode": blend, "maskCutoff": 0.5, "doubleSided": double_sided,
    }


def bc7_dds(img: np.ndarray) -> bytes:
    """An (H, W, 4) uint8 image (sides multiples of 4) as a one-mip BC7 DDS
    with the DX10 header (DXGI_FORMAT_BC7_UNORM)."""
    h, w = img.shape[:2]
    pf = struct.pack("<II4sIIIII", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    hdr = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 1) + b"\0" * 44 + pf
           + b"\0" * 20)
    dx10 = struct.pack("<5I", 98, 3, 0, 1, 0)
    return hdr + dx10 + bc7.compress_bc7_mode6(img).tobytes()


def _light(kind: str, name: str, t, q, data_index: int, data: dict, color=(1, 1, 1)) -> dict:
    return {"type": kind, "name": name, "color": _xyz(color), "transform": _trs(t, q),
            "castsShadows": True, "customConstantBias": 0.0, "customSlopeBias": 0.0,
            "data": {"index": data_index, "data": data}}


def _look_quat(direction) -> np.ndarray:
    """The unit quaternion (x, y, z, w) turning -Z (a light's forward) to
    ``direction``."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    f = np.array([0.0, 0.0, -1.0])
    axis = np.cross(f, d)
    s = np.linalg.norm(axis)
    if s < 1e-9:
        return np.array([0, 0, 0, 1.0]) if d @ f > 0 else np.array([0, 1.0, 0, 0])
    angle = np.arctan2(s, f @ d)
    return np.concatenate([axis / s * np.sin(angle / 2), [np.cos(angle / 2)]])


def _camera_quat(eye, target) -> np.ndarray:
    """The orientation ``Camera.look_at(eye, target)`` sets (y up)."""
    view = mx.look_at(np.asarray(eye, np.float32), np.asarray(target, np.float32),
                      (0.0, 1.0, 0.0))
    return mx.quat_from_mat3(view[:3, :3].T)


def write_level(root: Path) -> dict:
    """Write the tree under ``root`` (see the module docstring); returns the
    paths by name ("level", "box", "sphere", "set", "opaque", "glass",
    "albedo", "sky")."""
    rng = np.random.default_rng(0)
    a = Path(root) / "assets"
    for sub in ("tex", "mat", "mesh", "set", "env"):
        (a / sub).mkdir(parents=True, exist_ok=True)
    paths = {"albedo": a / "tex" / "albedo.png", "opaque": a / "mat" / "opaque.arkmat",
             "glass": a / "mat" / "glass.arkmat", "box": a / "mesh" / "box.arkmsh",
             "sphere": a / "mesh" / "sphere.arkmsh", "set": a / "set" / "pair.arkset",
             "sky": a / "env" / "sky.dds", "level": a / "level.arklvl"}

    checker = (np.indices((32, 32)).sum(0) // 4 % 2).astype(np.uint8)
    albedo = np.stack([60 + 150 * checker, 90 + 100 * checker,
                       rng.integers(40, 200, (32, 32)).astype(np.uint8),
                       np.full((32, 32), 255)], -1).astype(np.uint8)
    save_png(str(paths["albedo"]), albedo)
    paths["opaque"].write_text(json.dumps({"material": material_doc(
        (0.9, 0.85, 0.8, 1.0), "Opaque", "assets/tex/albedo.png", metallic=0.1,
        roughness=0.6)}, indent=4) + "\n")
    cereal_binary.write_ark_binary(paths["glass"], material_doc(
        (0.3, 0.6, 0.95, 0.45), "Translucent", roughness=0.1, double_sided=True))
    cereal_binary.write_ark_binary(paths["box"], mesh_doc(
        make_box((1.0, 1.0, 1.0)), "assets/mat/opaque.arkmat", "box", as_json=False))
    paths["sphere"].write_text(json.dumps({"mesh": mesh_doc(
        make_uv_sphere(0.6, rings=10, sectors=20), "assets/mat/glass.arkmat", "sphere",
        as_json=True, normals=False)}, indent=4) + "\n")
    save_arkset(paths["set"], {
        "name": "pair", "transform": _trs((0.0, 0.0, -2.0)), "meshIndex": -1,
        "children": [{"name": "left", "transform": _trs((-1.5, 0.5, 0.0)), "meshIndex": 0},
                     {"name": "right", "transform": _trs((1.5, 0.5, 0.0), s=(0.5, 0.5, 0.5)),
                      "meshIndex": 0,
                      "children": [{"name": "top", "transform": _trs((0.0, 2.0, 0.0)),
                                    "meshIndex": 1}]}],
    }, ["assets/mesh/box.arkmsh", "assets/mesh/sphere.arkmsh"], name="pair")
    y, x = np.mgrid[0:32, 0:64]
    sky = np.stack([80 + x * 2, 120 + y * 3, np.full_like(x, 230), np.full_like(x, 255)],
                   -1).astype(np.uint8)
    paths["sky"].write_bytes(bc7_dds(sky))

    def obj(name, t, s=(1, 1, 1), mesh="", set_ref=""):
        return {"name": name, "transform": _trs(t, s=s),
                "mesh": {"index": 0, "data": mesh}, "set": set_ref, "hair": ""}

    level = {
        "name": "fixture",
        "objects": [
            obj("floor", (0.0, -0.5, 0.0), (12.0, 0.05, 12.0), mesh="assets/mesh/box.arkmsh"),
            obj("box", (-1.0, 0.0, 0.0), mesh="assets/mesh/box.arkmsh"),
            obj("glass", (0.6, 0.4, 1.2), mesh="assets/mesh/sphere.arkmsh"),
            obj("pair", (0.0, 0.0, -1.0), set_ref="assets/set/pair.arkset"),
        ],
        "lights": [
            _light("DirectionalLight", "sun", (0, 10, 0), _look_quat((0.35, -1.0, -0.25)), 0,
                   {"illuminance": 90000.0, "shadowMapWorldExtent": 50.0}),
            _light("SpotLight", "spot", (1.5, 3.0, 1.5), _look_quat((-0.3, -1.0, -0.3)), 2,
                   {"iesProfilePath": "", "luminousIntensity": 20000.0,
                    "outerConeAngle": 0.6}, color=(1.0, 0.9, 0.8)),
            _light("PointLight", "point", (-2.0, 1.5, 2.0), (0, 0, 0, 1), 1,
                   {"luminousPower": 800.0, "lightRadius": 5.0, "lightSourceRadius": 0.1}),
        ],
        "cameras": [{
            "position": _xyz((3.5, 2.2, 4.5)),
            "orientation": _xyz(_camera_quat((3.5, 2.2, 4.5), (0.0, 0.4, 0.0)), "xyzw"),
            "nearClipPlane": 0.25, "farClipPlane": 10000.0, "focusMode": "Manual",
            "focalLength": 30.0, "focusDepth": 5.0, "sensorSize": {"x": 36.0, "y": 24.0},
            "exposureMode": "Manual", "fNumber": 16.0, "iso": 400.0, "shutterSpeed": 0.0025,
            "exposureCompensation": 0.0, "adaptionRate": 0.0018,
        }],
        "environmentMap": {"assetPath": "assets/env/sky.dds", "brightnessFactor": 6000.0},
        "probeGrid": None,
    }
    paths["level"].write_text(json.dumps({"level": level}, indent=4) + "\n")
    return paths
