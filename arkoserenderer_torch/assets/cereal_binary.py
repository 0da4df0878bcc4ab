"""cereal Binary-archive codec for the reference's baked ``.ark*`` assets (port
of arkoserenderer_tpu/assets/cereal_binary.py, byte for byte).

The reference's canonical bake pipeline writes ``AssetStorage::Binary``
(tools/ArkAssetBakeTool.cpp:35-59): a u32 magic header (Asset.h:76-99,
four chars packed little-endian) followed by a plain cereal
``BinaryOutputArchive`` stream (MeshAsset.cpp:888-910 and equivalents).
This module encodes/decodes that stream from/to the SAME Python document
shape cereal's JSON archives produce, so ``assets/ark.py``'s loaders accept
either storage flavor through one code path.

cereal Binary encoding rules (mirrored exactly; versions match the
reference's CEREAL_CLASS_VERSION declarations):

* arithmetic types: raw little-endian bytes; ``bool`` is 1 byte
* ``std::string``: u64 size + bytes
* ``std::vector<T>``: u64 size + elements (contiguous for arithmetic T)
* ``std::optional<T>``: 1-byte nullopt flag, then the value when present
  (cereal/types/optional.hpp) — decoded as ``{"nullopt": bool[, "data"]}``
* ``std::variant<Ts...>``: i32 alternative index + value
  (cereal/types/variant.hpp) — decoded as ``{"index": i, "data": v}``
* non-polymorphic ``std::unique_ptr<T>``: 1-byte valid flag + value
  (cereal/types/memory.hpp) — decoded as
  ``{"ptr_wrapper": {"valid": n, "data": v}}`` (SetAsset node children)
* enums with ``save_minimal -> std::string`` (Brdf / BlendMode /
  ImageFilter / ImageWrapMode / animation enums): stored as strings
* versioned classes (``serialize(Archive&, u32 version)``): a u32
  ``cereal_class_version`` precedes the FIRST object of each such type in
  the archive and is cached for later occurrences
  (cereal::OutputArchive::registerClassVersion) — including per template
  instantiation (each AnimationChannelAsset<T> is its own type)

Field orders and version gates follow the asset headers verbatim:
MeshAsset.h:208-288, MaterialAsset.h:150-214, SkeletonAsset.h:43-60,
AnimationAsset.h:106-160, LevelAsset.h serialize bodies, SetAsset.h:47-66,
HairAsset.h:57-73. Vectors of numeric/vec records decode as numpy arrays
(fast path); ark.py consumes both that and the JSON list-of-dicts shape.
"""

from __future__ import annotations

import struct as _struct
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# Schema nodes


class Prim:
    def __init__(self, fmt: str, np_dtype):
        self.fmt = fmt                      # struct format char
        self.size = _struct.calcsize("<" + fmt)
        self.np_dtype = np_dtype


F32 = Prim("f", np.float32)
U64 = Prim("Q", np.uint64)
U32 = Prim("I", np.uint32)
I32 = Prim("i", np.int32)
U16 = Prim("H", np.uint16)
U8 = Prim("B", np.uint8)


class Bool:
    pass


class Str:
    pass


# Enum serialized via save_minimal -> std::string (magic_enum name).
class EnumStr(Str):
    pass


BOOL = Bool()
STR = Str()
ESTR = EnumStr()


class Vec:
    """A component struct of N like-typed scalars serialized member-wise
    (ark::vec2/3/4, quat, ark::tvec4<u16>) — decoded as {"x": ...} when a
    single value, or as an (n, N) numpy array inside vectors."""

    def __init__(self, comps: str, prim: Prim = F32):
        self.comps = comps
        self.prim = prim


VEC2, VEC3, VEC4 = Vec("xy"), Vec("xyz"), Vec("xyzw")
QUAT = Vec("xyzw")
UVEC4_U16 = Vec("xyzw", U16)


class Arr:
    def __init__(self, elem):
        self.elem = elem


class Opt:
    def __init__(self, elem):
        self.elem = elem


class Var:
    def __init__(self, alts: list):
        self.alts = alts


class Uptr:
    def __init__(self, elem):
        self.elem = elem


class Field:
    def __init__(self, name: str, schema, since: int = 0):
        self.name = name
        self.schema = schema
        self.since = since  # present when class version >= since


class Struct:
    """Ordered fields; ``version`` is not None for cereal-versioned classes
    (serialize taking a u32 version): the u32 class version is written
    before the first instance of ``version_key`` in the archive."""

    def __init__(self, version_key: str | None, fields: list[Field],
                 version: int | None = None):
        self.version_key = version_key
        self.fields = fields
        self.version = version


# ---------------------------------------------------------------------------
# Reader / writer


class _Reader:
    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off
        self.versions: dict[str, int] = {}

    def prim(self, p: Prim):
        v = _struct.unpack_from("<" + p.fmt, self.buf, self.off)[0]
        self.off += p.size
        return v

    def read(self, schema):
        if isinstance(schema, Prim):
            return self.prim(schema)
        if isinstance(schema, Bool):
            return bool(self.prim(U8))
        if isinstance(schema, Str):  # covers EnumStr
            n = self.prim(U64)
            s = self.buf[self.off:self.off + n].decode("utf-8")
            self.off += n
            return s
        if isinstance(schema, Vec):
            return {c: (float(self.prim(schema.prim))
                        if schema.prim is F32 else int(self.prim(schema.prim)))
                    for c in schema.comps}
        if isinstance(schema, Arr):
            n = self.prim(U64)
            e = schema.elem
            if isinstance(e, Prim):
                a = np.frombuffer(self.buf, e.np_dtype, n, self.off).copy()
                self.off += n * e.size
                return a
            if isinstance(e, Vec):
                k = len(e.comps)
                a = np.frombuffer(self.buf, e.prim.np_dtype, n * k,
                                  self.off).copy().reshape(n, k)
                self.off += n * k * e.prim.size
                return a
            return [self.read(e) for _ in range(n)]
        if isinstance(schema, Opt):
            if self.prim(U8):
                return {"nullopt": True}
            return {"nullopt": False, "data": self.read(schema.elem)}
        if isinstance(schema, Var):
            idx = self.prim(I32)
            return {"index": int(idx), "data": self.read(schema.alts[idx])}
        if isinstance(schema, Uptr):
            valid = self.prim(U8)
            w = {"valid": int(valid)}
            if valid:
                w["data"] = self.read(schema.elem)
            return {"ptr_wrapper": w}
        if isinstance(schema, Struct):
            v = 0
            if schema.version is not None:
                key = schema.version_key
                if key not in self.versions:
                    self.versions[key] = self.prim(U32)
                v = self.versions[key]
            out = {}
            if schema.version is not None:
                out["cereal_class_version"] = v
            for f in schema.fields:
                if f.since <= v:
                    out[f.name] = self.read(f.schema)
            return out
        raise TypeError(f"unknown schema node {schema!r}")


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []
        self.versions: set[str] = set()

    def prim(self, p: Prim, v):
        self.parts.append(_struct.pack("<" + p.fmt, v))

    def write(self, schema, v):
        if isinstance(schema, Prim):
            self.prim(schema, v)
        elif isinstance(schema, Bool):
            self.prim(U8, 1 if v else 0)
        elif isinstance(schema, Str):
            b = ("" if v is None else str(v)).encode("utf-8")
            self.prim(U64, len(b))
            self.parts.append(b)
        elif isinstance(schema, Vec):
            arr = _vec_values(v, schema.comps)
            for x in arr:
                self.prim(schema.prim, x)
        elif isinstance(schema, Arr):
            e = schema.elem
            if isinstance(e, Prim):
                a = np.asarray([] if v is None else v, e.np_dtype).ravel()
                self.prim(U64, len(a))
                self.parts.append(a.astype(e.np_dtype, copy=False)
                                  .tobytes(order="C"))
            elif isinstance(e, Vec):
                a = _vec_rows(v, e.comps, e.prim.np_dtype)
                self.prim(U64, a.shape[0])
                self.parts.append(a.tobytes(order="C"))
            else:
                seq = v or []
                self.prim(U64, len(seq))
                for item in seq:
                    self.write(e, item)
        elif isinstance(schema, Opt):
            if isinstance(v, dict) and "nullopt" in v:
                v = None if v["nullopt"] else v.get("data")
            if v is None:
                self.prim(U8, 1)
            else:
                self.prim(U8, 0)
                self.write(schema.elem, v)
        elif isinstance(schema, Var):
            idx = int(v["index"])
            self.prim(I32, idx)
            self.write(schema.alts[idx], v["data"])
        elif isinstance(schema, Uptr):
            # Accept the cereal-JSON {"ptr_wrapper": {"valid", "data"}}
            # shape, a bare node dict, or None.
            if isinstance(v, dict) and "ptr_wrapper" in v:
                w = v["ptr_wrapper"]
                data = w.get("data") if w.get("valid") else None
            else:
                data = v
            if data is None:
                self.prim(U8, 0)
            else:
                self.prim(U8, 1)
                self.write(schema.elem, data)
        elif isinstance(schema, Struct):
            ver = 0
            if schema.version is not None:
                ver = schema.version
                if schema.version_key not in self.versions:
                    self.versions.add(schema.version_key)
                    self.prim(U32, ver)
            for f in schema.fields:
                if f.since <= ver:
                    self.write(f.schema, _default_for(f, v))
        else:
            raise TypeError(f"unknown schema node {schema!r}")

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _vec_values(v, comps: str):
    if isinstance(v, dict):
        return [v[c] for c in comps]
    a = np.asarray(v).ravel()
    assert len(a) == len(comps), (a.shape, comps)
    return list(a)


def _vec_rows(v, comps: str, dtype) -> np.ndarray:
    k = len(comps)
    if v is None:
        return np.zeros((0, k), dtype)
    if isinstance(v, np.ndarray):
        return np.ascontiguousarray(v.reshape(-1, k).astype(dtype, copy=False))
    if len(v) and isinstance(v[0], dict):
        return np.array([[row[c] for c in comps] for row in v], dtype)
    return np.asarray(v, dtype).reshape(-1, k)


_ZERO_DEFAULTS = {
    "metallicFactor": 0.0, "roughnessFactor": 0.0, "clearcoat": 0.0,
    "clearcoatRoughness": 0.0, "transmissionFactor": 0.0, "maskCutoff": 1.0,
    "indexOfRefraction": 1.5, "minLOD": 0, "maxLOD": 99,
}


def _default_for(f: Field, container: dict):
    if f.name in container:
        return container[f.name]
    s = f.schema
    if isinstance(s, Opt):
        return None
    if isinstance(s, Arr):
        return []
    if isinstance(s, (Str, EnumStr)):
        return ""
    if isinstance(s, Bool):
        return False
    if isinstance(s, Vec):
        return {c: 0.0 for c in s.comps}
    if isinstance(s, Prim):
        return _ZERO_DEFAULTS.get(f.name, 0)
    if isinstance(s, Struct):
        return {}
    raise KeyError(f"missing field {f.name!r} with no default")


# ---------------------------------------------------------------------------
# Asset schemas (field orders + version gates from the reference headers)

TRANSFORM = Struct(None, [
    Field("translation", VEC3), Field("orientation", QUAT),
    Field("scale", VEC3),
])
SPHERE = Struct(None, [Field("center", VEC3), Field("radius", F32)])
AABB3 = Struct(None, [Field("min", VEC3), Field("max", VEC3)])
MAT4 = Struct(None, [Field(c, VEC4) for c in "xyzw"])
EXTENT3D = Struct(None, [
    Field("width", U32), Field("height", U32), Field("depth", U32),
])

# --- MeshAsset (.arkmsh), versions: MeshAsset.h:189-206, latest = 3
_MESH_V = 3
MESHLET = Struct("MeshletAsset", [
    Field("firstIndex", U32), Field("triangleCount", U32),
    Field("firstVertex", U32), Field("vertexCount", U32),
    Field("center", VEC3), Field("radius", F32),
], version=_MESH_V)
MESHLET_DATA = Struct("MeshletDataAsset", [
    Field("meshlets", Arr(MESHLET)),
    Field("meshletVertexIndirection", Arr(U32)),
    Field("meshletIndices", Arr(U32)),
], version=_MESH_V)
OMM_DATA = Struct("OpacityMicroMapDataAsset", [
    Field("ommSdkSerializedData", Arr(U8)),
], version=_MESH_V)
MORPH_TARGET = Struct("MorphTargetAsset", [
    Field("name", STR, since=3),  # AddMorphTargetNames
    Field("positions", Arr(VEC3)), Field("normals", Arr(VEC3)),
    Field("tangents", Arr(VEC3)),
], version=_MESH_V)
MESH_SEGMENT = Struct("MeshSegmentAsset", [
    Field("positions", Arr(VEC3)), Field("texcoord0s", Arr(VEC2)),
    Field("normals", Arr(VEC3)), Field("tangents", Arr(VEC4)),
    Field("jointIndices", Arr(UVEC4_U16)), Field("jointWeights", Arr(VEC4)),
    Field("morphTargets", Arr(MORPH_TARGET), since=2),  # AddMorphTargets
    Field("indices", Arr(U32)),
    Field("meshletData", Opt(MESHLET_DATA)),
    Field("opacityMicroMapData", Opt(OMM_DATA), since=1),  # AddOpacityMicroMaps
    Field("material", STR),
], version=_MESH_V)
MESH_LOD = Struct("MeshLODAsset", [
    Field("meshSegments", Arr(MESH_SEGMENT)),
], version=_MESH_V)
MESH = Struct("MeshAsset", [
    Field("name", STR), Field("LODs", Arr(MESH_LOD)),
    Field("minLOD", U32), Field("maxLOD", U32),
    Field("boundingBox", AABB3), Field("boundingSphere", SPHERE),
], version=_MESH_V)

# --- MaterialAsset (.arkmat), versions: MaterialAsset.h:131-146, latest = 6
_MAT_V = 6
WRAP_MODES = Struct(None, [Field(c, ESTR) for c in "uvw"])
MATERIAL_INPUT = Struct("MaterialInput", [
    Field("image", STR), Field("wrapModes", WRAP_MODES),
    Field("minFilter", ESTR), Field("magFilter", ESTR),
    Field("useMipmapping", BOOL), Field("mipFilter", ESTR),
], version=_MAT_V)
MATERIAL = Struct("MaterialAsset", [
    Field("brdf", ESTR),
    Field("baseColor", Opt(MATERIAL_INPUT)),
    Field("emissiveColor", Opt(MATERIAL_INPUT)),
    Field("normalMap", Opt(MATERIAL_INPUT)),
    Field("bentNormalMap", Opt(MATERIAL_INPUT), since=2),
    Field("materialProperties", Opt(MATERIAL_INPUT)),
    Field("occlusionMap", Opt(MATERIAL_INPUT), since=3),
    Field("colorTint", VEC4),
    Field("metallicFactor", F32), Field("roughnessFactor", F32),
    Field("emissiveFactor", VEC3, since=1),
    Field("clearcoat", F32, since=4), Field("clearcoatRoughness", F32, since=4),
    Field("indexOfRefraction", F32, since=5),
    Field("transmissionFactor", F32, since=6),
    Field("transmissionMap", Opt(MATERIAL_INPUT), since=6),
    Field("blendMode", ESTR), Field("maskCutoff", F32),
    Field("doubleSided", BOOL),
], version=_MAT_V)

# --- SkeletonAsset (.arkskel), latest = 0; joints recurse
SKELETON_JOINT = Struct("SkeletonJointAsset", [
    Field("name", STR), Field("index", U32),
    Field("transform", TRANSFORM), Field("invBindMatrix", MAT4),
    # children: filled in below (self-recursive)
], version=0)
SKELETON_JOINT.fields.append(Field("children", Arr(SKELETON_JOINT)))
SKELETON = Struct("SkeletonAsset", [
    Field("name", STR), Field("rootJoint", SKELETON_JOINT),
    Field("maxJointIdx", U32),
], version=0)

# --- AnimationAsset (.arkanim), latest = 0; channel/sampler templates are
# distinct versioned types per instantiation
def _sampler(tag: str, elem) -> Struct:
    return Struct(f"AnimationSamplerAsset<{tag}>", [
        Field("inputTrackIdx", U32), Field("outputValues", Arr(elem)),
        Field("interpolation", ESTR),
    ], version=0)


def _channel(tag: str, elem) -> Struct:
    return Struct(f"AnimationChannelAsset<{tag}>", [
        Field("targetReference", STR), Field("targetProperty", ESTR),
        Field("sampler", _sampler(tag, elem)),
    ], version=0)


ANIMATION = Struct("AnimationAsset", [
    Field("name", STR),
    Field("inputTracks", Arr(Arr(F32))),
    Field("floatPropertyChannels", Arr(_channel("f32", F32))),
    Field("float2PropertyChannels", Arr(_channel("vec2", VEC2))),
    Field("float3PropertyChannels", Arr(_channel("vec3", VEC3))),
    Field("float4PropertyChannels", Arr(_channel("vec4", VEC4))),
], version=0)

# --- LevelAsset (.arklvl), unversioned (serialize without version arg)
ENV_MAP = Struct(None, [Field("assetPath", STR), Field("brightnessFactor", F32)])
PROBE_GRID = Struct(None, [
    Field("gridDimensions", EXTENT3D), Field("probeSpacing", VEC3),
    Field("offsetToFirst", VEC3),
])
DIR_LIGHT_DATA = Struct(None, [
    Field("illuminance", F32), Field("shadowMapWorldExtent", F32),
])
SPHERE_LIGHT_DATA = Struct(None, [
    Field("luminousPower", F32), Field("lightRadius", F32),
    Field("lightSourceRadius", F32),
])
SPOT_LIGHT_DATA = Struct(None, [
    Field("iesProfilePath", STR), Field("luminousIntensity", F32),
    Field("outerConeAngle", F32),
])
LIGHT = Struct(None, [
    Field("type", STR), Field("name", STR), Field("color", VEC3),
    Field("transform", TRANSFORM), Field("castsShadows", BOOL),
    Field("customConstantBias", F32), Field("customSlopeBias", F32),
    Field("data", Var([DIR_LIGHT_DATA, SPHERE_LIGHT_DATA, SPOT_LIGHT_DATA])),
])
CAMERA = Struct(None, [
    Field("position", VEC3), Field("orientation", QUAT),
    Field("nearClipPlane", F32), Field("farClipPlane", F32),
    Field("focusMode", STR), Field("focalLength", F32),
    Field("focusDepth", F32), Field("sensorSize", VEC2),
    Field("exposureMode", STR), Field("fNumber", F32), Field("iso", F32),
    Field("shutterSpeed", F32), Field("exposureCompensation", F32),
    Field("adaptionRate", F32),
])
SCENE_OBJECT = Struct(None, [
    Field("name", STR), Field("transform", TRANSFORM),
    Field("mesh", Var([STR, I32])),
    Field("set", STR), Field("hair", STR),
])
LEVEL = Struct(None, [
    Field("name", STR), Field("objects", Arr(SCENE_OBJECT)),
    Field("lights", Arr(LIGHT)), Field("cameras", Arr(CAMERA)),
    Field("environmentMap", Opt(ENV_MAP)), Field("probeGrid", Opt(PROBE_GRID)),
])

# --- SetAsset (.arkset), latest = 0; node children are unique_ptrs
SET_NODE = Struct("NodeAsset", [
    Field("name", STR), Field("transform", TRANSFORM),
    Field("meshIndex", I32), Field("lightIndex", I32),
    Field("cameraIndex", I32),
], version=0)
SET_NODE.fields.append(Field("children", Arr(Uptr(SET_NODE))))
SET = Struct("SetAsset", [
    Field("name", STR), Field("rootNode", SET_NODE),
    Field("meshAssets", Arr(STR)),
], version=0)

# --- HairAsset (.arkhair), latest = 0
HAIR = Struct("HairAsset", [
    Field("name", STR), Field("strandCount", U32),
    Field("positions", Arr(VEC3)), Field("indices", Arr(U32)),
    Field("defaultSegmentCount", U32), Field("defaultThickness", F32),
    Field("defaultTransparency", F32), Field("defaultColor", VEC3),
    Field("segmentCounts", Arr(U16)), Field("thickness", Arr(F32)),
    Field("transparency", Arr(F32)), Field("colors", Arr(VEC3)),
    Field("boundingBox", AABB3),
], version=0)

# magic (Asset.h AssetMagicValue, little-endian u32 on the wire) ->
# (json top-level nvp name, schema)
MAGICS: dict[bytes, tuple[str, Struct]] = {
    b"amsh": ("mesh", MESH),
    b"amat": ("material", MATERIAL),
    b"alvl": ("level", LEVEL),
    b"askl": ("skeleton", SKELETON),
    b"aanm": ("animation", ANIMATION),
    b"aset": ("set", SET),
    b"ahai": ("hair", HAIR),
}
_EXT_TO_MAGIC = {
    ".arkmsh": b"amsh", ".arkmat": b"amat", ".arklvl": b"alvl",
    ".arkskel": b"askl", ".arkanim": b"aanm", ".arkset": b"aset",
    ".arkhair": b"ahai",
}


def sniff_binary(data: bytes) -> tuple[str, Struct] | None:
    """Returns (json_key, schema) when ``data`` starts with a known asset
    magic (AssetHeader, Asset.h:76-99), else None (JSON flavor)."""
    return MAGICS.get(data[:4])


def decode(data: bytes) -> dict:
    """Binary .ark* bytes -> cereal-JSON-shaped document (the inner object,
    without the top-level nvp wrapper)."""
    found = sniff_binary(data)
    if found is None:
        raise ValueError(f"not a binary .ark* stream (head {data[:4]!r})")
    _, schema = found
    r = _Reader(data, off=4)
    doc = r.read(schema)
    return doc


def encode(ext_or_magic: str | bytes, doc: dict) -> bytes:
    """cereal-JSON-shaped document -> binary .ark* bytes (magic included)."""
    magic = (_EXT_TO_MAGIC[ext_or_magic] if isinstance(ext_or_magic, str)
             else ext_or_magic)
    _, schema = MAGICS[magic]
    w = _Writer()
    w.parts.append(magic)
    w.write(schema, doc)
    return w.getvalue()


def write_ark_binary(path: str | Path, doc: dict) -> None:
    """ArkAssetBakeTool analogue: write ``doc`` as AssetStorage::Binary,
    asset type derived from the file extension."""
    path = Path(path)
    path.write_bytes(encode(path.suffix, doc))
