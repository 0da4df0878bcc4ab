"""Scene: host authoring + fixed-capacity device pools (port of
arkoserenderer_tpu/scene/scene.py, static subset).

The host ``Scene`` owns segments, materials, textures, the sun and the
instances; ``build(device)`` freezes them into ``SceneArrays`` — SoA tensors
in unified pools with the reference's static capacities, so both packages
hold identical pools for the same scene.

The static subset: no skinning, morph targets, hair, meshlets, BVH or
streaming. Authoring those raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.core.types import SceneLimits
from arkoserenderer_torch.ops import mattex
from arkoserenderer_torch.scene.lights import (
    DirectionalLight,
    LightArrays,
    PointLight,
    SpotLight,
    build_light_arrays,
)

BLEND_OPAQUE = 0
BLEND_MASKED = 1
BLEND_TRANSLUCENT = 2

LOD_FAR = 3.4e38  # 'infinite' LOD band end (finite: no inf in device buffers)

WRAP_REPEAT = 0  # texture address modes (WRAP_CLAMP = 1)


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Construct-time scene facts the passes specialise on."""

    has_skin: bool = False
    n_spots: int = 0
    n_points: int = 0
    # Per-light shadow-caster flags: the spots' drive the local shadow
    # raster and the PCF branch of shading; the points' are for ray-traced
    # shadows, as are the source radii (world units).
    spot_shadow_casters: tuple = ()
    point_shadow_casters: tuple = ()
    spot_source_radius: tuple = ()
    point_source_radius: tuple = ()
    uses_base_tex: bool = True
    uses_normal_tex: bool = True
    uses_mr_tex: bool = True
    uses_emissive_tex: bool = False
    uses_occlusion_tex: bool = False
    has_hair: bool = False
    has_translucent: bool = False
    has_meshlets: bool = False
    has_morphs: bool = False
    dynamic: bool = False


@dataclasses.dataclass
class Material:
    """Host PBR material description."""

    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    emissive_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    metallic_factor: float = 0.0
    roughness_factor: float = 1.0
    base_color_tex: int = 0   # default white
    normal_tex: int = 2       # default flat normal
    mr_tex: int = 0
    emissive_tex: int = 0
    occlusion_tex: int = 0
    blend_mode: int = BLEND_OPAQUE
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    clearcoat: float = 0.0
    clearcoat_roughness: float = 0.0
    subsurface: float = 0.0


@dataclasses.dataclass
class MeshSegment:
    """One single-material geometry segment."""

    positions: np.ndarray               # (V, 3) f32
    normals: np.ndarray                 # (V, 3) f32
    uvs: np.ndarray | None = None       # (V, 2) f32
    tangents: np.ndarray | None = None  # (V, 4) f32 (xyz + handedness w)
    indices: np.ndarray | None = None   # (I,) int — None = iota
    material: int = 0

    def __post_init__(self):
        v = self.positions.shape[0]
        if self.uvs is None:
            self.uvs = np.zeros((v, 2), np.float32)
        if self.tangents is None:
            self.tangents = generate_tangents_simple(self.normals)
        if self.indices is None:
            self.indices = np.arange(v, dtype=np.int32)
        self.indices = self.indices.astype(np.int32)

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3


class MaterialArrays(NamedTuple):
    """SoA materials on the device."""

    base_color_factor: torch.Tensor   # (M, 4)
    emissive_factor: torch.Tensor     # (M, 3)
    metallic_factor: torch.Tensor     # (M,)
    roughness_factor: torch.Tensor    # (M,)
    base_color_tex: torch.Tensor      # (M,) i32
    normal_tex: torch.Tensor          # (M,) i32
    mr_tex: torch.Tensor              # (M,) i32
    emissive_tex: torch.Tensor        # (M,) i32
    occlusion_tex: torch.Tensor       # (M,) i32
    blend_mode: torch.Tensor          # (M,) i32
    alpha_cutoff: torch.Tensor        # (M,)
    double_sided: torch.Tensor        # (M,) bool
    clearcoat: torch.Tensor           # (M,)
    clearcoat_roughness: torch.Tensor  # (M,)
    subsurface: torch.Tensor          # (M,)


class SceneArrays(NamedTuple):
    """All device-resident scene data of the static subset."""

    positions: torch.Tensor        # (Vmax, 3) object space
    normals: torch.Tensor          # (Vmax, 3)
    uvs: torch.Tensor              # (Vmax, 2)
    tangents: torch.Tensor         # (Vmax, 4)
    vertex_instance: torch.Tensor  # (Vmax,) i32
    indices: torch.Tensor          # (Tmax, 3) i32 into the vertex pool
    tri_instance: torch.Tensor     # (Tmax,) i32
    tri_valid: torch.Tensor        # (Tmax,) bool
    world: torch.Tensor            # (Dmax, 4, 4)
    prev_world: torch.Tensor       # (Dmax, 4, 4)
    normal_mat: torch.Tensor       # (Dmax, 3, 3) inverse-transpose world
    inst_material: torch.Tensor    # (Dmax,) i32
    inst_sphere: torch.Tensor      # (Dmax, 4) world bounding sphere
    inst_valid: torch.Tensor       # (Dmax,) bool
    inst_lod_band: torch.Tensor    # (Dmax, 2) camera-distance band [near, far)
    materials: MaterialArrays
    tri_material: torch.Tensor     # (Tmax,) i32
    mat_records: torch.Tensor      # (Mmax, 32) f32 packed material records
    mat_tex: mattex.PackedTexturePool
    lights: LightArrays
    env_map: torch.Tensor          # (He, We, 3) f32 linear radiance
    env_brightness: torch.Tensor   # ()


# Nested NamedTuple fields of SceneArrays, by field name.
NESTED_FIELDS = {
    "materials": MaterialArrays,
    "mat_tex": mattex.PackedTexturePool,
    "lights": LightArrays,
}


def host_to_device(value: np.ndarray, device) -> torch.Tensor:
    """Copy a host array to ``device`` (uint32 texel rows become int32 with
    the same bits). Always a copy: later host edits never leak in."""
    a = np.array(value, copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def scene_arrays_from_host(fields: dict[str, np.ndarray], device) -> SceneArrays:
    """SceneArrays from host arrays keyed by field name, nested fields as
    ``"lights.sun_view_proj"`` and the like. Extra keys are ignored."""
    out = {}
    for name in SceneArrays._fields:
        cls = NESTED_FIELDS.get(name)
        if cls is None:
            out[name] = host_to_device(fields[name], device)
        else:
            out[name] = cls(**{
                f: host_to_device(fields[f"{name}.{f}"], device) for f in cls._fields
            })
    return SceneArrays(**out)


class Scene:
    """Host scene container; ``build(device)`` freezes it to SceneArrays."""

    def __init__(self, limits: SceneLimits | None = None):
        self.limits = limits or SceneLimits()
        self.materials: list[Material] = [Material()]  # 0 = default
        self.segments: list[MeshSegment] = []
        self.instances: list[tuple] = []  # (segment id, world 4x4)
        # Bindless texture list (img_rgba8, srgb, wrap); ids 0-3 are the
        # defaults white, black, flat normal and mid-gray.
        self.images: list[tuple[np.ndarray, bool, int]] = []
        for rgba in ([255, 255, 255, 255], [0, 0, 0, 255],
                     [128, 128, 255, 255], [128, 128, 128, 255]):
            self.add_texture(np.full((1, 1, 4), rgba, np.uint8), srgb=False)
        self.sun: DirectionalLight | None = None
        self.spots: list[SpotLight] = []
        self.points: list[PointLight] = []
        self.env_map: np.ndarray = np.zeros((1, 2, 3), np.float32)
        self.env_brightness: float = 1.0
        self.ambient_lx: float = 0.0

    # -- authoring --------------------------------------------------------------

    def add_material(self, mat: Material) -> int:
        if len(self.materials) >= self.limits.max_materials:
            raise ValueError("material capacity exceeded")
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_texture(self, img: np.ndarray, *, srgb: bool, wrap: int = WRAP_REPEAT) -> int:
        """Add an (H, W, C<=4) uint8 image; returns its bindless texture id."""
        if len(self.images) >= self.limits.max_textures:
            raise ValueError("texture id capacity exceeded")
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] < 4:
            pad = np.zeros(img.shape[:2] + (4 - img.shape[2],), np.uint8)
            pad[..., -1] = 255  # alpha defaults to opaque
            img = np.concatenate([img, pad], axis=-1)
        self.images.append((img, srgb, wrap))
        return len(self.images) - 1

    def add_segment(self, seg: MeshSegment) -> int:
        self.segments.append(seg)
        return len(self.segments) - 1

    def add_instance(self, segment_id: int, world: np.ndarray) -> int:
        """Returns the new instance id. Static: prev_world = world, and the
        LOD band is [0, LOD_FAR)."""
        self.instances.append((segment_id, np.asarray(world, np.float32)))
        return len(self.instances) - 1

    def set_env_map(self, img: np.ndarray, brightness: float = 1.0):
        self.env_map = np.asarray(img, np.float32)
        self.env_brightness = brightness

    # -- freeze -----------------------------------------------------------------

    def build_host(self) -> dict[str, np.ndarray]:
        """Every SceneArrays field as host arrays (nested as "a.b")."""
        lim = self.limits
        vmax, tmax, dmax, mmax = (
            lim.max_vertices, lim.max_triangles, lim.max_drawables, lim.max_materials,
        )
        positions = np.zeros((vmax, 3), np.float32)
        normals = np.zeros((vmax, 3), np.float32)
        uvs = np.zeros((vmax, 2), np.float32)
        tangents = np.zeros((vmax, 4), np.float32)
        vertex_instance = np.zeros((vmax,), np.int32)
        indices = np.zeros((tmax, 3), np.int32)
        tri_instance = np.zeros((tmax,), np.int32)
        tri_valid = np.zeros((tmax,), bool)
        world = np.tile(np.eye(4, dtype=np.float32), (dmax, 1, 1))
        prev_world = world.copy()
        normal_mat = np.tile(np.eye(3, dtype=np.float32), (dmax, 1, 1))
        inst_material = np.zeros((dmax,), np.int32)
        inst_sphere = np.zeros((dmax, 4), np.float32)
        inst_valid = np.zeros((dmax,), bool)
        inst_lod_band = np.tile(np.array([0.0, LOD_FAR], np.float32), (dmax, 1))

        if len(self.instances) > dmax:
            raise ValueError("drawable capacity exceeded")
        v_cursor = 0
        t_cursor = 0
        for inst_id, (sid, w) in enumerate(self.instances):
            seg = self.segments[sid]
            v = seg.positions.shape[0]
            t = seg.num_triangles
            if v_cursor + v > vmax or t_cursor + t > tmax:
                raise ValueError("vertex or triangle pool capacity exceeded")
            positions[v_cursor:v_cursor + v] = seg.positions
            normals[v_cursor:v_cursor + v] = seg.normals
            uvs[v_cursor:v_cursor + v] = seg.uvs
            tangents[v_cursor:v_cursor + v] = seg.tangents
            vertex_instance[v_cursor:v_cursor + v] = inst_id
            indices[t_cursor:t_cursor + t] = seg.indices.reshape(t, 3) + v_cursor
            tri_instance[t_cursor:t_cursor + t] = inst_id
            tri_valid[t_cursor:t_cursor + t] = True
            world[inst_id] = w
            prev_world[inst_id] = w
            normal_mat[inst_id] = np.linalg.inv(w[:3, :3]).T
            inst_material[inst_id] = seg.material
            center_obj = 0.5 * (seg.positions.min(0) + seg.positions.max(0))
            r_obj = np.linalg.norm(seg.positions - center_obj, axis=-1).max()
            scale = np.linalg.norm(w[:3, :3], axis=0).max()
            center_w = w[:3, :3] @ center_obj + w[:3, 3]
            inst_sphere[inst_id] = (*center_w, r_obj * scale)
            inst_valid[inst_id] = True
            v_cursor += v
            t_cursor += t

        if len(self.materials) > mmax:
            raise ValueError("material capacity exceeded")
        ms = self.materials
        out = {
            "positions": positions, "normals": normals, "uvs": uvs,
            "tangents": tangents, "vertex_instance": vertex_instance,
            "indices": indices, "tri_instance": tri_instance,
            "tri_valid": tri_valid, "world": world, "prev_world": prev_world,
            "normal_mat": normal_mat, "inst_material": inst_material,
            "inst_sphere": inst_sphere, "inst_valid": inst_valid,
            "inst_lod_band": inst_lod_band,
            "materials.base_color_factor": _soa([x.base_color_factor for x in ms], (mmax, 4)),
            "materials.emissive_factor": _soa([x.emissive_factor for x in ms], (mmax, 3)),
            "materials.metallic_factor": _soa([x.metallic_factor for x in ms], (mmax,)),
            "materials.roughness_factor": _soa([x.roughness_factor for x in ms], (mmax,), fill=1.0),
            "materials.base_color_tex": _soa([x.base_color_tex for x in ms], (mmax,), np.int32),
            "materials.normal_tex": _soa([x.normal_tex for x in ms], (mmax,), np.int32, fill=2),
            "materials.mr_tex": _soa([x.mr_tex for x in ms], (mmax,), np.int32),
            "materials.emissive_tex": _soa([x.emissive_tex for x in ms], (mmax,), np.int32),
            "materials.occlusion_tex": _soa([x.occlusion_tex for x in ms], (mmax,), np.int32),
            "materials.blend_mode": _soa([x.blend_mode for x in ms], (mmax,), np.int32),
            "materials.alpha_cutoff": _soa([x.alpha_cutoff for x in ms], (mmax,), fill=0.5),
            "materials.double_sided": _soa([x.double_sided for x in ms], (mmax,), bool),
            "materials.clearcoat": _soa([x.clearcoat for x in ms], (mmax,)),
            "materials.clearcoat_roughness": _soa([x.clearcoat_roughness for x in ms], (mmax,)),
            "materials.subsurface": _soa([x.subsurface for x in ms], (mmax,)),
            "tri_material": inst_material[tri_instance].astype(np.int32),
        }

        # Packed material records + channel-packed texel pool, padded to the
        # configured pool size.
        tex_rows, tex_meta = mattex.build_packed_materials(ms, self.images)
        cap_rows = max(int(lim.texture_pool_texels), tex_rows.shape[0])
        if cap_rows > tex_rows.shape[0]:
            tex_rows = np.concatenate(
                [tex_rows, np.zeros((cap_rows - tex_rows.shape[0], 3), np.uint32)]
            )
        out["mat_tex.rows"] = tex_rows
        mat_records = np.zeros((mmax, 32), np.float32)
        for i, x in enumerate(ms):
            mat_records[i, 0:4] = x.base_color_factor
            mat_records[i, 4:7] = x.emissive_factor
            mat_records[i, 7] = x.metallic_factor
            mat_records[i, 8] = x.roughness_factor
            mat_records[i, 9] = 1.0 if x.double_sided else 0.0
            mat_records[i, 10] = x.clearcoat
            mat_records[i, 11] = x.clearcoat_roughness
            mat_records[i, 12] = x.subsurface
            mat_records[i, 13] = x.alpha_cutoff
            mat_records[i, 14] = x.blend_mode
            mat_records[i, 15:32] = tex_meta[i]
        out["mat_records"] = mat_records

        center, radius = self.bounding_sphere()
        lights = build_light_arrays(
            self.sun, self.spots, self.points,
            exposure=1.0,  # raw units; pre-exposure happens in shading
            scene_center=center, scene_radius=radius,
            max_spots=lim.max_spot_lights, max_points=lim.max_point_lights,
            ambient_lx=self.ambient_lx,
        )
        out.update({f"lights.{k}": v for k, v in lights.items()})
        out["env_map"] = self.env_map
        out["env_brightness"] = np.asarray(self.env_brightness, np.float32)
        return out

    def build(self, device="cuda") -> SceneArrays:
        return scene_arrays_from_host(self.build_host(), device)

    def static_info(self) -> SceneStatic:
        mats = self.materials
        return SceneStatic(
            n_spots=len(self.spots),
            n_points=len(self.points),
            spot_shadow_casters=tuple(bool(sp.cast_shadows) for sp in self.spots),
            point_shadow_casters=tuple(bool(p.cast_shadows) for p in self.points),
            spot_source_radius=tuple(float(sp.source_radius) for sp in self.spots),
            point_source_radius=tuple(float(p.source_radius) for p in self.points),
            uses_base_tex=any(m.base_color_tex != 0 for m in mats),
            uses_normal_tex=any(m.normal_tex != 2 for m in mats),
            uses_mr_tex=any(m.mr_tex != 0 for m in mats),
            uses_emissive_tex=any(m.emissive_tex != 0 for m in mats),
            uses_occlusion_tex=any(m.occlusion_tex != 0 for m in mats),
            has_translucent=any(m.blend_mode == BLEND_TRANSLUCENT for m in mats),
        )

    def bounding_sphere(self) -> tuple[np.ndarray, float]:
        if not self.instances:
            return np.zeros(3, np.float32), 1.0
        mins = np.full(3, np.inf)
        maxs = np.full(3, -np.inf)
        for sid, w in self.instances:
            pts = self.segments[sid].positions @ w[:3, :3].T + w[:3, 3]
            mins = np.minimum(mins, pts.min(0))
            maxs = np.maximum(maxs, pts.max(0))
        center = 0.5 * (mins + maxs)
        radius = float(np.linalg.norm(maxs - center))
        return center.astype(np.float32), max(radius, 1e-3)


def _soa(values, shape, dtype=np.float32, fill=0.0):
    arr = np.full(shape, fill, dtype)
    if values:
        arr[: len(values)] = np.asarray(values, dtype)
    return arr


def generate_tangents_simple(normals: np.ndarray) -> np.ndarray:
    """Arbitrary-but-stable tangent frame from normals."""
    n = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    helper = np.where(
        (np.abs(n[:, 1:2]) < 0.99), np.array([[0.0, 1.0, 0.0]]), np.array([[1.0, 0.0, 0.0]])
    )
    t = np.cross(helper, n)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-9)
    return np.concatenate([t, np.ones((len(n), 1), np.float32)], axis=-1).astype(np.float32)


def generate_tangents_uv(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    """Per-vertex tangents from UV derivatives (Lengyel's method), averaged
    over incident triangles and Gram-Schmidt-orthogonalised to the normal."""
    tri = indices.reshape(-1, 3)
    p = positions[tri]
    t = uvs[tri]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    d1 = t[:, 1] - t[:, 0]
    d2 = t[:, 2] - t[:, 0]
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tan = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    acc = np.zeros_like(positions)
    np.add.at(acc, tri[:, 0], tan)
    np.add.at(acc, tri[:, 1], tan)
    np.add.at(acc, tri[:, 2], tan)
    n = normals
    acc = acc - n * np.sum(acc * n, axis=-1, keepdims=True)
    ln = np.linalg.norm(acc, axis=-1, keepdims=True)
    fallback = generate_tangents_simple(normals)[:, :3]
    tan = np.where(ln > 1e-8, acc / np.maximum(ln, 1e-12), fallback)
    return np.concatenate([tan, np.ones((len(n), 1), np.float32)], axis=-1).astype(np.float32)
