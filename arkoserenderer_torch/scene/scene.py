"""Scene: host authoring + fixed-capacity device pools (port of
arkoserenderer_tpu/scene/scene.py, static subset).

The host ``Scene`` owns segments, materials, textures, the sun and the
instances; ``build(device)`` freezes them into ``SceneArrays`` — SoA tensors
in unified pools with the reference's static capacities, so both packages
hold identical pools for the same scene.

Instances may carry a previous transform, a LOD band and an animation clip
(``add_instance``, ``add_instance_lods``); ``update_instance_transforms``
re-uploads the instance rows from a host mirror after the host moved
instances. Skinned segments index a skeleton (``add_skeleton``): the build
gives each skinned instance a range of the (MAX_JOINTS, 4, 4) palette pool,
and ``update_animations`` evaluates the clips into a new pool for the frame
to upload. Morphed segments carry position and normal deltas: each morphed
instance is one block of the vertex pool with its own weights
(``set_morph_weights``, or a clip's "weights" channel). With
``enable_meshlets`` the build splits every segment into meshlets
(``assets/meshopt.build_meshlets``) and records their culling bounds.
``build(device, with_bvh=True)`` adds the two-level BVH over the LOD-0
instances (``ops/bvh``), with the reference's parked TLAS slots for
streamed instances; without it ``bvh`` is None. A skinned or morphed
instance gets a BLAS of its own in world space, which the per-frame refit
(``ops/bvh.refit_bvh``) re-reads from the deformed vertex pool.

Not ported: hair and streaming.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.assets import meshopt
from arkoserenderer_torch.core.types import SceneLimits
from arkoserenderer_torch.ops import bvh as bvh_ops
from arkoserenderer_torch.ops import mattex
from arkoserenderer_torch.ops import texture as tex_ops
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

MAX_JOINTS = 256  # skinning palette capacity, every skeleton instance together
LOD_FAR = 3.4e38  # 'infinite' LOD band end (finite: no inf in device buffers)

WRAP_REPEAT = tex_ops.WRAP_REPEAT  # texture address modes
WRAP_CLAMP = tex_ops.WRAP_CLAMP


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
    sun_angular_radius_deg: float = 0.0
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
    # Vertex-pool base of each morphed instance's block, in instance order.
    morph_vertex_base: tuple = ()
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
    skin_joints: np.ndarray | None = None   # (V, 4) i32 into its skeleton
    skin_weights: np.ndarray | None = None  # (V, 4) f32
    skeleton: int = -1                      # Scene.skeletons index when skinned
    morph_pos: np.ndarray | None = None     # (B, V, 3) position deltas
    morph_nrm: np.ndarray | None = None     # (B, V, 3) normal deltas
    name: str = ""                          # the asset's name (.arkmsh, glTF mesh)

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
    tri_meshlet: torch.Tensor      # (Tmax,) i32 owning meshlet (for culling)
    world: torch.Tensor            # (Dmax, 4, 4)
    prev_world: torch.Tensor       # (Dmax, 4, 4)
    normal_mat: torch.Tensor       # (Dmax, 3, 3) inverse-transpose world
    inst_material: torch.Tensor    # (Dmax,) i32
    inst_sphere: torch.Tensor      # (Dmax, 4) world bounding sphere
    inst_valid: torch.Tensor       # (Dmax,) bool
    inst_lod_band: torch.Tensor    # (Dmax, 2) camera-distance band [near, far)
    materials: MaterialArrays
    textures: tex_ops.TexturePool  # the RGBA8 bindless pool (linear-space mips)
    tri_material: torch.Tensor     # (Tmax,) i32
    mat_records: torch.Tensor      # (Mmax, 32) f32 packed material records
    mat_tex: mattex.PackedTexturePool
    lights: LightArrays
    env_map: torch.Tensor          # (He, We, 3) f32 linear radiance
    env_brightness: torch.Tensor   # ()
    # Meshlets: object-space culling bounds and the owning instance; one
    # invalid placeholder row when the scene was built without meshlets.
    meshlet_sphere: torch.Tensor   # (Mm, 4) centre xyz + radius
    meshlet_cone: torch.Tensor     # (Mm, 4) axis xyz + cutoff
    meshlet_instance: torch.Tensor  # (Mm,) i32
    meshlet_valid: torch.Tensor    # (Mm,) bool
    # Skinning: palette indices and weights per vertex (all-zero weights: a
    # static vertex) and the palette the host uploads each frame.
    skin_joints: torch.Tensor      # (Vmax, 4) i32
    skin_weights: torch.Tensor     # (Vmax, 4) f32
    palette: torch.Tensor          # (MAX_JOINTS, 4, 4) joint world @ inverse bind
    # Morph targets, one entry per morphed instance (SceneStatic.morph_vertex_base).
    morph_pos: tuple               # of (B_i, V_i, 3) position deltas
    morph_nrm: tuple               # of (B_i, V_i, 3) normal deltas
    morph_weights: tuple           # of (B_i,)
    # Ray tracing: ops.bvh.TwoLevelBVH when built with_bvh, else None.
    bvh: bvh_ops.TwoLevelBVH | None


# Tuple fields of SceneArrays: entry i is host key "<name>.<i>".
TUPLE_FIELDS = ("morph_pos", "morph_nrm", "morph_weights")

# Nested NamedTuple fields of SceneArrays, by field name.
NESTED_FIELDS = {
    "materials": MaterialArrays,
    "textures": tex_ops.TexturePool,
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
    ``"lights.sun_view_proj"`` and the like, tuple entries as
    ``"morph_pos.0"``. Extra keys are ignored. The BVH
    comes from "bvh.*" keys holding a two-level BVH's fields; without them
    (or with the reference's one-leaf placeholder, which has no
    ``wide_rec``) it is None."""
    out = {}
    for name in SceneArrays._fields:
        cls = NESTED_FIELDS.get(name)
        if name == "bvh":
            sub = {k[4:]: v for k, v in fields.items() if k.startswith("bvh.")}
            out[name] = bvh_ops.bvh_from_host(sub, device) if "wide_rec" in sub else None
        elif name in TUPLE_FIELDS:
            n = 0
            while f"{name}.{n}" in fields:
                n += 1
            out[name] = tuple(host_to_device(fields[f"{name}.{i}"], device) for i in range(n))
        elif cls is None:
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
        # (segment id, world 4x4, previous world 4x4 or None, LOD band)
        self.instances: list[tuple] = []
        self.instance_clips: dict[int, int] = {}  # instance id -> animation clip id
        self.skeletons: list = []   # scene.animation.Skeleton
        self.animations: list = []  # scene.animation.AnimationClip
        self._palette_pool = np.tile(np.eye(4, dtype=np.float32), (MAX_JOINTS, 1, 1))
        self._bindings: list[tuple] = []  # (skeleton id, palette base, clip id), by build()
        # Morph blocks (vertex base, segment id, clip id), one per morphed
        # instance, by build(); weights per block. Overrides keep
        # set_morph_weights calls made before build().
        self._morph_blocks: list[tuple] = []
        self._morph_weights_list: list[np.ndarray] = []
        self._morph_weight_overrides: dict[int, np.ndarray] = {}
        self.enable_meshlets = False  # meshlet-granularity culling (build + Geometry)
        self.build_times: dict[str, float] = {}  # host seconds of the last build_host
        self._mirror: dict[str, np.ndarray] | None = None  # instance pools of the last build
        self._seg_bounds: dict[int, tuple[np.ndarray, float]] = {}
        # Bindless textures: the RGBA8 pool (``ops/texture``), whose image
        # list (``images``) the packed pool is built from too; ids 0-3 are
        # the defaults white, black, flat normal and mid-gray.
        self.texture_builder = tex_ops.TexturePoolBuilder(
            max_textures=self.limits.max_textures, pool_capacity=self.limits.texture_pool_texels)
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

    @property
    def images(self) -> list[tuple[np.ndarray, bool, int]]:
        """The bindless textures by id: (RGBA8 image, srgb, wrap)."""
        return self.texture_builder.images

    def add_texture(self, img: np.ndarray, *, srgb: bool, wrap: int = WRAP_REPEAT) -> int:
        """Add an (H, W, C<=4) uint8 image to both texture pools; returns its
        bindless texture id."""
        return self.texture_builder.add(img, srgb=srgb, wrap=wrap)

    def add_segment(self, seg: MeshSegment) -> int:
        self.segments.append(seg)
        return len(self.segments) - 1

    def add_mesh(self, segments: list[MeshSegment]) -> list[int]:
        return [self.add_segment(s) for s in segments]

    def add_instance(self, segment_ids, world: np.ndarray, prev_world=None,
                     clip: int | None = None, lod_band=(0.0, LOD_FAR)) -> int:
        """One instance of each segment id in ``segment_ids`` (an int or a
        list); returns the first new instance id. ``prev_world`` (None:
        ``world``) feeds the velocity of moving instances; ``clip`` (an
        ``add_animation`` id) drives a skinned instance's skeleton or a
        morphed instance's weights; the instance renders while the camera's
        distance lies in ``lod_band`` = [near, far)."""
        first = len(self.instances)
        for sid in [segment_ids] if isinstance(segment_ids, (int, np.integer)) else segment_ids:
            self.instances.append(
                (sid, np.asarray(world, np.float32), prev_world, lod_band))
            if clip is not None:
                self.instance_clips[len(self.instances) - 1] = clip
        return first

    def instance_transform(self, instance_id: int) -> np.ndarray:
        return self.instances[instance_id][1]

    def add_skeleton(self, skeleton) -> int:
        self.skeletons.append(skeleton)
        return len(self.skeletons) - 1

    def add_animation(self, clip) -> int:
        self.animations.append(clip)
        return len(self.animations) - 1

    def set_morph_weights(self, weights: np.ndarray, block: int = 0):
        """Morph-target weights of one morphed instance (blocks in instance
        order, as SceneStatic.morph_vertex_base)."""
        w = np.asarray(weights, np.float32)
        self._morph_weight_overrides[block] = w
        if block < len(self._morph_weights_list):
            self._morph_weights_list[block] = w

    def _rebuild_morph_weights(self) -> list[np.ndarray]:
        """The weight list sized to the current blocks, keeping weights
        whose target count still matches (set before or after build)."""
        out = []
        for i, (_b, sid, _c) in enumerate(self._morph_blocks):
            nb = self.segments[sid].morph_pos.shape[0]
            w = self._morph_weight_overrides.get(i)
            if w is None and i < len(self._morph_weights_list):
                w = self._morph_weights_list[i]
            if w is None or w.shape[0] != nb:
                w = np.zeros((nb,), np.float32)
            out.append(np.asarray(w, np.float32))
        self._morph_weights_list = out
        return out

    def morph_weights(self) -> list[np.ndarray]:
        """The current weights of each morph block."""
        return self._morph_weights_list

    def _morph_bases_for_static(self) -> tuple:
        """Vertex-pool base of every morphed instance, in instance order."""
        bases = []
        base = 0
        for sid, *_ in self.instances:
            if self.segments[sid].morph_pos is not None:
                bases.append(base)
            base += self.segments[sid].positions.shape[0]
        return tuple(bases)

    def update_animations(self, time: float) -> np.ndarray:
        """Advance every skeleton and morph clip to ``time``; returns the
        new (MAX_JOINTS, 4, 4) palette pool for the caller to upload with
        ``morph_weights()``. A skeleton's clip that carries weights drives
        block 0; a morphed instance's own clip drives its block."""
        from arkoserenderer_torch.scene.animation import evaluate_pose, sample_channel

        for skel_id, base, clip_id in self._bindings:
            skel = self.skeletons[skel_id]
            clip = self.animations[clip_id] if clip_id is not None else None
            palette, morph = evaluate_pose(skel, clip, time)
            self._palette_pool[base:base + skel.num_joints] = palette
            if morph is not None and self._morph_weights_list:
                self._morph_weights_list[0] = morph
        for i, (_b, _sid, clip_id) in enumerate(self._morph_blocks):
            if clip_id is None:
                continue
            clip = self.animations[clip_id]
            d = clip.duration
            t = time % d if d > 0 else time
            for ch in clip.channels:
                if ch.path == "weights":
                    self._morph_weights_list[i] = np.asarray(
                        sample_channel(ch, t), np.float32).reshape(-1)
        return self._palette_pool

    def add_instance_lods(self, lod_segment_ids: list, world: np.ndarray,
                          distances: list, prev_world=None) -> None:
        """One instance with a discrete LOD chain: ``lod_segment_ids[i]``
        renders while the camera distance is in [distances[i-1],
        distances[i]) (one switch distance between consecutive levels; the
        last level runs to LOD_FAR). Every level lives in the pools; the
        selection is a per-frame distance-band mask."""
        if len(distances) != len(lod_segment_ids) - 1:
            raise ValueError("need one switch distance between consecutive LOD levels")
        edges = [0.0, *[float(d) for d in distances], LOD_FAR]
        for i, sid in enumerate(lod_segment_ids):
            self.add_instance(sid, world, prev_world=prev_world,
                              lod_band=(edges[i], edges[i + 1]))

    def set_env_map(self, img: np.ndarray, brightness: float = 1.0):
        self.env_map = np.asarray(img, np.float32)
        self.env_brightness = brightness

    # -- freeze -----------------------------------------------------------------

    def build_host(self, with_bvh: bool = False,
                   rt_stream_capacity: int = 64) -> dict[str, np.ndarray]:
        """Every SceneArrays field as host arrays (nested as "a.b"); the
        BVH's as "bvh.*" when ``with_bvh``. Records the host seconds of its
        stages in ``build_times``: the pools ("pools_s"), the packed
        materials ("packing_s") and the BVH ("bvh_s", 0 without one)."""
        t0 = time.perf_counter()
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

        skin_joints = np.zeros((vmax, 4), np.int32)
        skin_weights = np.zeros((vmax, 4), np.float32)
        self._morph_blocks = []
        self._bindings = []
        palette_cursor = 0
        tri_meshlet = np.zeros((tmax,), np.int32)
        meshlet_rows: list[tuple] = []  # (sphere4, cone4, instance)
        seg_meshlets: dict[int, meshopt.Meshlets] = {}

        if len(self.instances) > dmax:
            raise ValueError("drawable capacity exceeded")
        v_cursor = 0
        t_cursor = 0
        for inst_id, (sid, w, pw, lod_band) in enumerate(self.instances):
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
            clip = self.instance_clips.get(inst_id)
            if seg.morph_pos is not None:
                self._morph_blocks.append((v_cursor, sid, clip))
            if seg.skeleton >= 0:
                # Each skinned instance gets its own palette range.
                from arkoserenderer_torch.scene.animation import evaluate_pose

                skel = self.skeletons[seg.skeleton]
                base = palette_cursor
                palette_cursor += skel.num_joints
                if palette_cursor > MAX_JOINTS:
                    raise ValueError("joint palette capacity exceeded")
                skin_joints[v_cursor:v_cursor + v] = seg.skin_joints + base
                skin_weights[v_cursor:v_cursor + v] = seg.skin_weights
                self._bindings.append((seg.skeleton, base, clip))
                self._palette_pool[base:base + skel.num_joints] = evaluate_pose(
                    skel, None, 0.0)[0]
            indices[t_cursor:t_cursor + t] = seg.indices.reshape(t, 3) + v_cursor
            tri_instance[t_cursor:t_cursor + t] = inst_id
            tri_valid[t_cursor:t_cursor + t] = True
            if self.enable_meshlets:
                # Built once per segment; culling bounds recorded per instance.
                if sid not in seg_meshlets:
                    seg_meshlets[sid] = meshopt.build_meshlets(
                        seg.positions, seg.indices, max_verts=64, max_tris=126)
                ml = seg_meshlets[sid]
                base_ml = len(meshlet_rows)
                for mi in range(ml.count):
                    o, c = ml.tri_offset[mi], ml.tri_count[mi]
                    tri_meshlet[t_cursor + o:t_cursor + o + c] = base_ml + mi
                    meshlet_rows.append((ml.sphere[mi], ml.cone[mi], inst_id))
            world[inst_id] = w
            prev_world[inst_id] = pw if pw is not None else w
            normal_mat[inst_id] = np.linalg.inv(w[:3, :3]).T
            inst_material[inst_id] = seg.material
            center_obj, r_obj = self._segment_bounds(sid)
            scale = np.linalg.norm(w[:3, :3], axis=0).max()
            center_w = w[:3, :3] @ center_obj + w[:3, 3]
            inst_sphere[inst_id] = (*center_w, r_obj * scale)
            inst_valid[inst_id] = True
            inst_lod_band[inst_id] = lod_band
            v_cursor += v
            t_cursor += t
        # The host mirror of the instance pools: update_instance_transforms
        # rewrites it and uploads copies, never reading the device back.
        self._mirror = {
            "world": world, "prev_world": prev_world, "normal_mat": normal_mat,
            "inst_sphere": inst_sphere, "inst_lod_band": inst_lod_band,
        }

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
            "inst_lod_band": inst_lod_band, "tri_meshlet": tri_meshlet,
            "meshlet_sphere": np.array([m[0] for m in meshlet_rows], np.float32)
            if meshlet_rows else np.zeros((1, 4), np.float32),
            "meshlet_cone": np.array([m[1] for m in meshlet_rows], np.float32)
            if meshlet_rows else np.array([[0, 0, 1, -1]], np.float32),
            "meshlet_instance": np.array([m[2] for m in meshlet_rows], np.int32)
            if meshlet_rows else np.zeros((1,), np.int32),
            "meshlet_valid": np.ones((max(len(meshlet_rows), 1),), bool)
            if meshlet_rows else np.zeros((1,), bool),
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
            "skin_joints": skin_joints, "skin_weights": skin_weights,
            "palette": self._palette_pool,
        }
        for i, (_b, sid, _c) in enumerate(self._morph_blocks):
            out[f"morph_pos.{i}"] = self.segments[sid].morph_pos.astype(np.float32)
            out[f"morph_nrm.{i}"] = self.segments[sid].morph_nrm.astype(np.float32)
        for i, w in enumerate(self._rebuild_morph_weights()):
            out[f"morph_weights.{i}"] = w

        # Packed material records + channel-packed texel pool, padded to the
        # configured pool size.
        t1 = time.perf_counter()
        tex_rows, tex_meta = mattex.build_packed_materials(ms, self.images)
        cap_rows = max(int(lim.texture_pool_texels), tex_rows.shape[0])
        if cap_rows > tex_rows.shape[0]:
            tex_rows = np.concatenate(
                [tex_rows, np.zeros((cap_rows - tex_rows.shape[0], 3), np.uint32)]
            )
        out["mat_tex.rows"] = tex_rows
        out.update({f"textures.{k}": v for k, v in self.texture_builder.host_fields().items()})
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
        t2 = time.perf_counter()

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
        t3 = time.perf_counter()
        if with_bvh:
            out.update({f"bvh.{k}": v for k, v in self._build_bvh(rt_stream_capacity).items()})
        self.build_times = {"pools_s": (t1 - t0) + (t3 - t2), "packing_s": t2 - t1,
                            "bvh_s": time.perf_counter() - t3}
        return out

    def build(self, device="cuda", with_bvh: bool = False,
              rt_stream_capacity: int = 64) -> SceneArrays:
        """The scene's SceneArrays on ``device``. ``with_bvh`` builds the
        two-level BVH on the host and moves it once; ``rt_stream_capacity``
        parked TLAS slots are reserved as the reference reserves them for
        streaming (they shape the TLAS, so both packages trace the same
        tree)."""
        return scene_arrays_from_host(self.build_host(with_bvh, rt_stream_capacity), device)

    def _build_bvh(self, stream_capacity: int = 0) -> dict:
        """The two-level BVH's host arrays: one BLAS per static segment in
        object space, shared by its instances, and a TLAS over the LOD-0
        instances (bands starting at distance 0), so a ray never finds one
        surface at several LOD levels. A skinned or morphed instance gets a
        BLAS of its own in world space (an identity transform) whose
        triangles the refit re-reads from the deformed pool
        (``blas_owner``). Fully transparent triangles of masked materials
        are left out (``_masked_tri_opacity``)."""
        omm_cache: dict[int, np.ndarray | None] = {}
        blas_geo: list[tuple] = []
        blas_owner: list[int] = []
        seg_blas: dict[int, int] = {}
        inst_blas, inst_o2w, inst_tri_base, inst_ids = [], [], [], []
        tri_cursor = 0
        for inst_id, (sid, w, _pw, lod_band) in enumerate(self.instances):
            seg = self.segments[sid]
            t = seg.num_triangles
            base = tri_cursor
            tri_cursor += t
            if lod_band[0] != 0.0:
                continue
            if sid not in omm_cache:
                omm_cache[sid] = self._masked_tri_opacity(seg)
            tris = seg.indices.reshape(t, 3).astype(np.int32)
            keep = omm_cache[sid]
            tri_ids = None
            if keep is not None:
                tri_ids = np.nonzero(keep)[0].astype(np.int32)
                tris = tris[keep]
            if seg.skeleton >= 0 or seg.morph_pos is not None:
                wm = np.asarray(w, np.float32)
                wp = seg.positions @ wm[:3, :3].T + wm[:3, 3]
                blas_geo.append((wp.astype(np.float32), tris, tri_ids))
                blas_owner.append(len(inst_ids))
                inst_blas.append(len(blas_geo) - 1)
                inst_o2w.append(np.eye(4, dtype=np.float32))
            else:
                if sid not in seg_blas:
                    seg_blas[sid] = len(blas_geo)
                    blas_geo.append((seg.positions.astype(np.float32), tris, tri_ids))
                    blas_owner.append(-1)
                inst_blas.append(seg_blas[sid])
                inst_o2w.append(np.asarray(w, np.float32))
            inst_tri_base.append(base)
            inst_ids.append(inst_id)
        return bvh_ops.build_two_level_host(
            blas_geo,
            np.asarray(inst_blas, np.int32),
            np.stack(inst_o2w) if inst_o2w else np.zeros((0, 4, 4), np.float32),
            np.asarray(inst_tri_base, np.int32),
            blas_owner=np.asarray(blas_owner, np.int32) if blas_owner else None,
            inst_id=np.asarray(inst_ids, np.int32),
            inst_cap=(len(inst_ids) + stream_capacity) if stream_capacity else None,
        )

    def _masked_tri_opacity(self, seg) -> np.ndarray | None:
        """(T,) keep-mask of a segment whose material is MASKED, or None when
        every triangle is kept: the base-colour texture's alpha sampled at
        each triangle's corners, edge midpoints and centroid; a triangle
        whose every sample is under the cutoff is fully transparent and left
        out of ray tracing (the role of the reference's opacity
        micromaps)."""
        mat = self.materials[seg.material]
        if mat.blend_mode != BLEND_MASKED:
            return None
        tid = int(mat.base_color_tex)
        if not (0 <= tid < len(self.images)) or tid in (0, 1, 2, 3):
            return None
        img = self.images[tid][0]
        h, w = img.shape[:2]
        if img.shape[-1] < 4:
            return None
        alpha = img[..., 3].astype(np.float32) / 255.0
        uv = seg.uvs[seg.indices.reshape(-1, 3)]  # (T, 3, 2)
        bary = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, 0], [0.5, 0, 0.5],
                         [0, 0.5, 0.5], [1 / 3, 1 / 3, 1 / 3]], np.float32)
        pts = np.einsum("kj,tjc->tkc", bary, uv)  # (T, 7, 2)
        xi = np.clip((np.mod(pts[..., 0], 1.0) * w).astype(np.int64), 0, w - 1)
        yi = np.clip((np.mod(pts[..., 1], 1.0) * h).astype(np.int64), 0, h - 1)
        keep = (alpha[yi, xi] >= mat.alpha_cutoff).any(axis=1)
        if keep.all():
            return None
        if not keep.any():
            keep[0] = True  # keep one triangle
        return keep

    def _segment_bounds(self, sid: int) -> tuple[np.ndarray, float]:
        """Object-space bounding sphere (AABB centre, radius) of a segment,
        computed once."""
        if sid not in self._seg_bounds:
            pos = self.segments[sid].positions
            c = 0.5 * (pos.min(0) + pos.max(0))
            self._seg_bounds[sid] = (c.astype(np.float32),
                                     float(np.linalg.norm(pos - c, axis=-1).max()))
        return self._seg_bounds[sid]

    def update_instance_transforms(self, arrays: SceneArrays) -> SceneArrays:
        """``arrays`` with the instance rows (world, prev_world, normal_mat,
        inst_sphere, inst_lod_band) recomputed from ``instances``, as the
        host moved them: one vectorised update of the build's host mirror,
        then an upload of copies to the arrays' device. The vertex, index and
        texture pools are untouched and nothing is read back."""
        if self._mirror is None:
            raise RuntimeError("call build() before update_instance_transforms()")
        mir = self._mirror
        n = min(len(self.instances), self.limits.max_drawables)
        insts = self.instances[:n]
        w = np.stack([np.asarray(it[1], np.float32) for it in insts])
        pw = np.stack([np.asarray(it[2] if it[2] is not None else it[1], np.float32)
                       for it in insts])
        mir["world"][:n] = w
        mir["prev_world"][:n] = pw
        mir["normal_mat"][:n] = np.transpose(np.linalg.inv(w[:, :3, :3]), (0, 2, 1))
        bounds = [self._segment_bounds(it[0]) for it in insts]
        centers = np.stack([b[0] for b in bounds])
        radii = np.array([b[1] for b in bounds], np.float32)
        scale = np.linalg.norm(w[:, :3, :3], axis=1).max(axis=-1)
        mir["inst_sphere"][:n, :3] = np.einsum("nij,nj->ni", w[:, :3, :3], centers) + w[:, :3, 3]
        mir["inst_sphere"][:n, 3] = radii * scale
        mir["inst_lod_band"][:n] = np.array([it[3] for it in insts], np.float32)
        dev = arrays.world.device
        return arrays._replace(**{k: host_to_device(v, dev) for k, v in mir.items()})

    def static_info(self) -> SceneStatic:
        mats = self.materials
        morph_bases = self._morph_bases_for_static()
        return SceneStatic(
            has_skin=any(self.segments[sid].skeleton >= 0 for sid, *_ in self.instances),
            n_spots=len(self.spots),
            n_points=len(self.points),
            spot_shadow_casters=tuple(bool(sp.cast_shadows) for sp in self.spots),
            point_shadow_casters=tuple(bool(p.cast_shadows) for p in self.points),
            spot_source_radius=tuple(float(sp.source_radius) for sp in self.spots),
            point_source_radius=tuple(float(p.source_radius) for p in self.points),
            sun_angular_radius_deg=(float(getattr(self.sun, "angular_radius_deg", 0.0))
                                    if self.sun is not None else 0.0),
            uses_base_tex=any(m.base_color_tex != 0 for m in mats),
            uses_normal_tex=any(m.normal_tex != 2 for m in mats),
            uses_mr_tex=any(m.mr_tex != 0 for m in mats),
            uses_emissive_tex=any(m.emissive_tex != 0 for m in mats),
            uses_occlusion_tex=any(m.occlusion_tex != 0 for m in mats),
            has_translucent=any(m.blend_mode == BLEND_TRANSLUCENT for m in mats),
            has_meshlets=self.enable_meshlets,
            has_morphs=bool(morph_bases),
            morph_vertex_base=morph_bases,
        )

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray] | None:
        """(mins, maxs) of the instances' world-space vertices (float64);
        None when the scene has no instance."""
        if not self.instances:
            return None
        mins = np.full(3, np.inf)
        maxs = np.full(3, -np.inf)
        for sid, w, *_ in self.instances:
            pts = self.segments[sid].positions @ w[:3, :3].T + w[:3, 3]
            mins = np.minimum(mins, pts.min(0))
            maxs = np.maximum(maxs, pts.max(0))
        return mins, maxs

    def bounding_sphere(self) -> tuple[np.ndarray, float]:
        box = self.bounding_box()
        if box is None:
            return np.zeros(3, np.float32), 1.0
        mins, maxs = box
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
