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
streamed instances; without it ``bvh`` is the reference's one-leaf flat
placeholder (``_dummy_bvh``), which every ray misses. A skinned, morphed or
hair instance gets a BLAS of its own in world space, which the per-frame
refit (``ops/bvh.refit_bvh``) re-reads from the deformed vertex pool.

Hair (``add_hair``, one batch a scene): strand points, tangents and radii
become ``hair_points`` / ``hair_tangents`` / ``hair_radius``, and a ribbon
segment of two vertices a point whose positions the Scene pass fills each
frame with camera-facing ribbons.

Streaming: after ``build``, ``stage_instance`` and ``stage_material`` plan
the rows a new instance (of an existing segment, rigid or skinned) or a new
material adds to the pools, from the host mirror of the last build, in a
load-safe order; ``stream_instance`` and ``stream_material`` write such a
plan at once (``rendering/streaming.StreamingManager`` writes it under a
byte budget a frame). Every write goes into the existing pool tensors in
place: each keeps its shape and its storage, and nothing is read back from
the device.
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
    hair_vertex_base: int = 0  # vertex-pool row of the hair segment's first vertex
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
    # Hair strands (one placeholder row without hair): world-space control
    # points that the Scene pass expands to camera-facing ribbons.
    hair_points: torch.Tensor      # (Hp, 3)
    hair_tangents: torch.Tensor    # (Hp, 3)
    hair_radius: torch.Tensor      # (Hp,)
    # Ray tracing: ops.bvh.TwoLevelBVH when built with_bvh, else the
    # one-leaf FlatBVH placeholder (_dummy_bvh) that every ray misses.
    bvh: bvh_ops.TwoLevelBVH | bvh_ops.FlatBVH


# The per-instance rows update_instance_transforms recomputes and uploads.
INSTANCE_ROWS = ("world", "prev_world", "normal_mat", "inst_sphere", "inst_lod_band")

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
    comes from "bvh.*" keys holding a two-level or a flat BVH's fields
    (``ops/bvh.bvh_from_host``); without them it is the no-BVH placeholder
    (``_dummy_bvh``)."""
    out = {}
    for name in SceneArrays._fields:
        cls = NESTED_FIELDS.get(name)
        if name == "bvh":
            sub = {k[4:]: v for k, v in fields.items() if k.startswith("bvh.")}
            out[name] = bvh_ops.bvh_from_host(sub, device) if sub else _dummy_bvh(device)
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


def _dummy_bvh(device) -> bvh_ops.FlatBVH:
    """The reference's placeholder BVH of a scene built without one: one
    leaf at the origin over a zero-area triangle, so every ray misses (its
    ``t`` stays ``t_max``, its ``tri`` -1)."""
    z3 = torch.zeros((1, 3), dtype=torch.float32, device=device)
    zi = torch.zeros((1,), dtype=torch.int32, device=device)
    one = torch.ones((1,), dtype=torch.int32, device=device)
    return bvh_ops.FlatBVH(node_min=z3, node_max=z3.clone(), left=zi, right=zi.clone(),
                           count=one, node_start=zi.clone(), node_end=one.clone(),
                           tri_order=zi.clone(), tri_v0=z3.clone(), tri_e1=z3.clone(),
                           tri_e2=z3.clone())


def pool_of(arrays: SceneArrays, field: str) -> torch.Tensor:
    """The pool tensor a plan's field names: "positions", or "mat_tex.rows"
    and "bvh.inst_o2w" inside a nested field."""
    obj = arrays
    for part in field.split("."):
        obj = getattr(obj, part)
    return obj


def host_rows(pool: torch.Tensor, offset: int, rows: np.ndarray) -> torch.Tensor:
    """``rows`` as a host tensor to write at ``pool[offset:]`` (uint32 texel
    rows as int32 with the same bits); IndexError when they run past the
    pool."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype == np.uint32:
        rows = rows.view(np.int32)
    n = rows.shape[0]
    if offset < 0 or offset + n > pool.shape[0]:
        raise IndexError(f"rows [{offset}, {offset + n}) outside a pool of {pool.shape[0]}")
    return torch.from_numpy(rows)


def write_rows(pool: torch.Tensor, offset: int, rows: np.ndarray) -> None:
    """``pool[offset:offset + len(rows)] = rows`` in place (uint32 texel
    rows as int32 with the same bits). The copy is blocking: it has read
    ``rows`` when it returns, so the caller may reuse the host buffer
    (``rendering/streaming`` writes its ticks through staging chunks)."""
    src = host_rows(pool, offset, rows)
    pool[offset:offset + src.shape[0]].copy_(src, non_blocking=False)


def write_lights(arrays: SceneArrays, lights: dict[str, np.ndarray]) -> None:
    """Write host light arrays (``build_light_arrays``) into the scene's
    light tensors in place."""
    for k, v in lights.items():
        getattr(arrays.lights, k).copy_(torch.from_numpy(np.array(v, copy=True)))


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
        # Host mirror of the last build's pools, cursors and skinning facts:
        # the instance-transform upload and streaming write it, never the
        # device's copy.
        self._mirror: dict | None = None
        self._mattex: dict | None = None  # packed texel pool: cursor, capacity
        self._bvh_stream: dict | None = None  # parked TLAS slots, static BLAS roots
        self._hair: tuple | None = None  # (points, tangents, radius, segment id)
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

    def add_hair(self, points: np.ndarray, segments: np.ndarray, material: int = 0,
                 radius: float | np.ndarray = 0.002) -> int:
        """Add hair strands: ``points`` (P, 3) world-space control points,
        strand after strand, and ``segments`` (S,) each strand's point count
        minus one; ``radius`` a scalar or one a point. The ribbon triangles
        are made here (two vertices a point, two triangles a strand
        segment) and the Scene pass places their vertices each frame. One
        hair batch a scene; returns the hair segment's id (instanced once,
        at the identity)."""
        if self._hair is not None:
            raise ValueError("one hair batch a scene")
        points = np.asarray(points, np.float32)
        p_total = len(points)
        radius = (np.full(p_total, radius, np.float32) if np.isscalar(radius)
                  else np.asarray(radius, np.float32))
        tangents = np.zeros((p_total, 3), np.float32)
        indices = []
        start = 0
        for seg_count in segments:
            n_pts = int(seg_count) + 1
            t = np.gradient(points[start:start + n_pts], axis=0)
            t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-9)
            tangents[start:start + n_pts] = t
            for i in range(n_pts - 1):
                l0, r0 = 2 * (start + i), 2 * (start + i) + 1
                l1, r1 = 2 * (start + i + 1), 2 * (start + i + 1) + 1
                indices.extend([l0, r0, l1, r0, r1, l1])
            start += n_pts
        seg = MeshSegment(
            positions=np.zeros((2 * p_total, 3), np.float32),  # placed by the Scene pass
            normals=np.tile(np.array([[0, 0, 1]], np.float32), (2 * p_total, 1)),
            uvs=np.zeros((2 * p_total, 2), np.float32),
            indices=np.array(indices, np.int32),
            material=material,
        )
        sid = self.add_segment(seg)
        self._hair = (points, tangents, radius, sid)
        self.add_instance(sid, np.eye(4, dtype=np.float32))
        return sid

    def _hair_vertex_base(self) -> int:
        """Vertex-pool row where the hair segment's instance starts."""
        if self._hair is None:
            return 0
        base = 0
        for sid, *_ in self.instances:
            if sid == self._hair[3]:
                return base
            base += self.segments[sid].positions.shape[0]
        raise ValueError("hair segment has no instance")

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
        # The host mirror of the pools: update_instance_transforms and the
        # streaming plans write it and upload copies, never reading the
        # device back.
        tri_material = inst_material[tri_instance].astype(np.int32)
        self._mirror = {
            "positions": positions, "normals": normals, "uvs": uvs, "tangents": tangents,
            "vertex_instance": vertex_instance, "indices": indices,
            "tri_instance": tri_instance, "tri_valid": tri_valid, "world": world,
            "prev_world": prev_world, "normal_mat": normal_mat,
            "inst_material": inst_material, "inst_sphere": inst_sphere,
            "inst_valid": inst_valid, "inst_lod_band": inst_lod_band,
            "tri_material": tri_material, "skin_joints": skin_joints,
            "skin_weights": skin_weights, "v_cursor": v_cursor, "t_cursor": t_cursor,
            "palette_cursor": palette_cursor,
            # A skinned instance streams only into a scene whose frame skins.
            "has_skin": any(self.segments[sid].skeleton >= 0 for sid, *_ in self.instances),
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
            "tri_material": tri_material,
            "skin_joints": skin_joints, "skin_weights": skin_weights,
            "palette": self._palette_pool,
        }
        for i, (_b, sid, _c) in enumerate(self._morph_blocks):
            out[f"morph_pos.{i}"] = self.segments[sid].morph_pos.astype(np.float32)
            out[f"morph_nrm.{i}"] = self.segments[sid].morph_nrm.astype(np.float32)
        for i, w in enumerate(self._rebuild_morph_weights()):
            out[f"morph_weights.{i}"] = w
        hair = self._hair
        out["hair_points"] = hair[0] if hair else np.zeros((1, 3), np.float32)
        out["hair_tangents"] = hair[1] if hair else np.zeros((1, 3), np.float32)
        out["hair_radius"] = hair[2] if hair else np.zeros((1,), np.float32)

        # Packed material records + channel-packed texel pool, padded to the
        # configured pool size.
        t1 = time.perf_counter()
        tex_rows, tex_meta = mattex.build_packed_materials(ms, self.images)
        cap_rows = max(int(lim.texture_pool_texels), tex_rows.shape[0])
        # Streamed materials append their chains into the padding.
        self._mattex = {"cursor": tex_rows.shape[0], "capacity": cap_rows}
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
        self._bvh_stream = None
        if with_bvh:
            out.update({f"bvh.{k}": v for k, v in self._build_bvh(rt_stream_capacity).items()})
        self.build_times = {"pools_s": (t1 - t0) + (t3 - t2), "packing_s": t2 - t1,
                            "bvh_s": time.perf_counter() - t3}
        return out

    def build(self, device="cuda", with_bvh: bool = False,
              rt_stream_capacity: int = 64) -> SceneArrays:
        """The scene's SceneArrays on ``device``. ``with_bvh`` builds the
        two-level BVH on the host and moves it once (without it the arrays
        carry the no-BVH placeholder); ``rt_stream_capacity``
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
        (``blas_owner``); so does the hair instance, whose pool rows the
        Scene pass writes. Fully transparent triangles of masked materials
        are left out (``_masked_tri_opacity``). With ``stream_capacity``
        parked slots, the free slots and each static segment's BLAS roots
        are kept for ``stage_instance``."""
        hair_sid = self._hair[3] if self._hair else -1
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
            if seg.skeleton >= 0 or seg.morph_pos is not None or sid == hair_sid:
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
        meta: dict = {}
        out = bvh_ops.build_two_level_host(
            blas_geo,
            np.asarray(inst_blas, np.int32),
            np.stack(inst_o2w) if inst_o2w else np.zeros((0, 4, 4), np.float32),
            np.asarray(inst_tri_base, np.int32),
            blas_owner=np.asarray(blas_owner, np.int32) if blas_owner else None,
            inst_id=np.asarray(inst_ids, np.int32),
            inst_cap=(len(inst_ids) + stream_capacity) if stream_capacity else None,
            meta_out=meta,
        )
        if stream_capacity:
            self._bvh_stream = {
                "free": list(range(meta["n_real"], meta["n_inst"])),
                "seg_root": {sid: (int(meta["roots_by_blas"][b]),
                                   int(meta["wide_root_of_blas"][b]))
                             for sid, b in seg_blas.items()},
            }
        return out

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
        computed once; the hair segment's from its strand points and radii
        (its pool positions are placed each frame)."""
        if sid not in self._seg_bounds:
            if self._hair is not None and sid == self._hair[3]:
                pos, _, radius, _ = self._hair
                pad = float(radius.max())
            else:
                pos, pad = self.segments[sid].positions, 0.0
            c = 0.5 * (pos.min(0) + pos.max(0))
            self._seg_bounds[sid] = (c.astype(np.float32),
                                     float(np.linalg.norm(pos - c, axis=-1).max()) + pad)
        return self._seg_bounds[sid]

    def update_instance_transforms(self, arrays: SceneArrays) -> SceneArrays:
        """``arrays`` with the instance rows (world, prev_world, normal_mat,
        inst_sphere, inst_lod_band) recomputed from ``instances``, as the
        host moved them: one vectorised update of the build's host mirror,
        then a copy into the arrays' own tensors on their device, which keep
        their storage (a captured frame reads them where it was captured).
        Returns ``arrays`` itself. The vertex, index and texture pools are
        untouched and nothing is read back."""
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
        for k in INSTANCE_ROWS:
            getattr(arrays, k).copy_(torch.from_numpy(np.array(mir[k], copy=True)))
        return arrays

    # -- streaming ----------------------------------------------------------------

    def stage_instance(self, segment_id: int, world: np.ndarray, lod_band=(0.0, LOD_FAR),
                       clip: int | None = None) -> dict:
        """Plan a new instance of an existing segment (rigid or skinned) in
        the pools of the last build: allocate its vertex, triangle and
        instance rows, write them to the host mirror, and return the upload
        plan {"instance_id", "uploads": [(field, row offset, host rows)],
        "lights" (the light arrays refitted to the grown bounds, as host
        arrays), "bvh_refit", "tri_range", "vert_range"}. The uploads are in
        a load-safe order: vertices, indices, the instance rows, and last
        ``tri_valid`` and ``inst_valid``, so a partly written instance never
        rasters. With parked TLAS slots left and a shared BLAS for the
        segment, the plan also writes the instance's "bvh.*" rows, which
        one refit folds into the TLAS and the traversal records. A skinned
        segment takes a palette range and needs a scene whose frame skins
        already. Full pools raise RuntimeError."""
        mir = self._mirror
        if mir is None:
            raise RuntimeError("call build() before staging instances")
        seg = self.segments[segment_id]
        if seg.morph_pos is not None:
            raise ValueError("a morphed segment cannot stream (morph blocks are built once)")
        if seg.skeleton >= 0 and not mir["has_skin"]:
            raise ValueError("cannot stream a skinned segment into a scene built without "
                             "skinned instances (the frame has no skinning path)")
        v, t = seg.positions.shape[0], seg.num_triangles
        vc, tc = mir["v_cursor"], mir["t_cursor"]
        inst_id = len(self.instances)
        lim = self.limits
        if vc + v > lim.max_vertices or tc + t > lim.max_triangles or \
                inst_id >= lim.max_drawables:
            raise RuntimeError("scene pools full — rebuild with larger limits")
        w = np.asarray(world, np.float32)
        self.instances.append((segment_id, w, None, lod_band))
        if clip is not None:
            self.instance_clips[inst_id] = clip
        mir["positions"][vc:vc + v] = seg.positions
        mir["normals"][vc:vc + v] = seg.normals
        mir["uvs"][vc:vc + v] = seg.uvs
        mir["tangents"][vc:vc + v] = seg.tangents
        mir["vertex_instance"][vc:vc + v] = inst_id
        skin_uploads = []
        if seg.skeleton >= 0:
            from arkoserenderer_torch.scene.animation import evaluate_pose

            skel = self.skeletons[seg.skeleton]
            base = mir["palette_cursor"]
            if base + skel.num_joints > MAX_JOINTS:
                raise RuntimeError("joint palette full — rebuild with fewer skinned instances")
            mir["palette_cursor"] = base + skel.num_joints
            mir["skin_joints"][vc:vc + v] = seg.skin_joints + base
            mir["skin_weights"][vc:vc + v] = seg.skin_weights
            self._bindings.append((seg.skeleton, base, clip))
            pal0 = evaluate_pose(skel, None, 0.0)[0]
            self._palette_pool[base:base + skel.num_joints] = pal0
            skin_uploads = [
                ("skin_joints", vc, (seg.skin_joints + base).astype(np.int32)),
                ("skin_weights", vc, seg.skin_weights.astype(np.float32)),
                ("palette", base, pal0.astype(np.float32)),
            ]
        mir["indices"][tc:tc + t] = seg.indices.reshape(t, 3) + vc
        mir["tri_instance"][tc:tc + t] = inst_id
        mir["tri_material"][tc:tc + t] = seg.material
        mir["tri_valid"][tc:tc + t] = True
        mir["world"][inst_id] = w
        mir["prev_world"][inst_id] = w
        mir["normal_mat"][inst_id] = np.linalg.inv(w[:3, :3]).T
        mir["inst_material"][inst_id] = seg.material
        center_obj = 0.5 * (seg.positions.min(0) + seg.positions.max(0))
        r_obj = np.linalg.norm(seg.positions - center_obj, axis=-1).max()
        scale = np.linalg.norm(w[:3, :3], axis=0).max()
        mir["inst_sphere"][inst_id] = (*(w[:3, :3] @ center_obj + w[:3, 3]), r_obj * scale)
        mir["inst_valid"][inst_id] = True
        mir["inst_lod_band"][inst_id] = lod_band
        mir["v_cursor"] = vc + v
        mir["t_cursor"] = tc + t

        # The sun's shadow fit follows the grown bounds, so a streamed scene
        # renders as its rebuild does.
        center, radius = self.bounding_sphere()
        lights = build_light_arrays(
            self.sun, self.spots, self.points, exposure=1.0,
            scene_center=center, scene_radius=radius,
            max_spots=lim.max_spot_lights, max_points=lim.max_point_lights,
            ambient_lx=self.ambient_lx,
        )
        one = np.s_[inst_id:inst_id + 1]
        uploads = skin_uploads + [
            ("positions", vc, seg.positions.astype(np.float32)),
            ("normals", vc, seg.normals.astype(np.float32)),
            ("uvs", vc, seg.uvs.astype(np.float32)),
            ("tangents", vc, seg.tangents.astype(np.float32)),
            ("vertex_instance", vc, np.full((v,), inst_id, np.int32)),
            ("indices", tc, (seg.indices.reshape(t, 3) + vc).astype(np.int32)),
            ("tri_instance", tc, np.full((t,), inst_id, np.int32)),
            ("tri_material", tc, np.full((t,), seg.material, np.int32)),
        ] + [(f, inst_id, mir[f][one].copy()) for f in (
            "world", "prev_world", "normal_mat", "inst_material", "inst_sphere",
            "inst_lod_band")] + [
            # Last: the geometry and the drawable become visible.
            ("tri_valid", tc, np.ones((t,), bool)),
            ("inst_valid", inst_id, np.ones((1,), bool)),
        ]

        # A parked TLAS slot makes the instance a leaf of the live BVH.
        bvh_refit = False
        bs = self._bvh_stream
        if bs and bs["free"] and segment_id in bs["seg_root"]:
            slot = bs["free"].pop(0)
            root, wroot = bs["seg_root"][segment_id]
            rot_inv = np.linalg.inv(w[:3, :3])
            w2o = np.concatenate([rot_inv, (-rot_inv @ w[:3, 3])[:, None]],
                                 axis=1).astype(np.float32)
            uploads += [
                ("bvh.inst_o2w", slot, w[:3, :4][None].astype(np.float32)),
                ("bvh.inst_w2o", slot + 1, w2o[None]),  # row 0 is the identity
                ("bvh.blas_root", slot, np.array([root], np.int32)),
                ("bvh.wide_root_blas", slot, np.array([wroot], np.int32)),
                ("bvh.inst_tri_base", slot, np.array([tc], np.int32)),
                ("bvh.inst_id", slot, np.array([inst_id], np.int32)),
                ("bvh.inst_active", slot, np.ones((1,), bool)),
            ]
            bvh_refit = True
        return {"instance_id": inst_id, "uploads": uploads, "lights": lights,
                "bvh_refit": bvh_refit, "tri_range": (tc, t), "vert_range": (vc, v)}

    def stage_material(self, mat: Material) -> dict:
        """Plan a new material whose texture chain appends to the packed
        texel pool's padding: {"material_id", "uploads": the texel rows
        first, the 32-lane record last (a material samples only once its
        texels are in), "lights": None, "instance_id": -1, "bvh_refit":
        False}. Its textures must be registered (``add_texture``) first.
        A full material table or texel pool raises RuntimeError, and the
        material is not kept."""
        mm = self._mattex
        if mm is None:
            raise RuntimeError("call build() before staging materials")
        if len(self.materials) >= self.limits.max_materials:
            raise RuntimeError("material table full")
        mid = len(self.materials)
        rows, meta_row, new_cursor = mattex.pack_material_chain(mat, self.images, mm["cursor"])
        if new_cursor > mm["capacity"]:
            raise RuntimeError("texel pool full — rebuild with a larger texture_pool_texels")
        self.materials.append(mat)
        rec = np.zeros((1, 32), np.float32)
        rec[0, 0:4] = mat.base_color_factor
        rec[0, 4:7] = mat.emissive_factor
        rec[0, 7] = mat.metallic_factor
        rec[0, 8] = mat.roughness_factor
        rec[0, 9] = 1.0 if mat.double_sided else 0.0
        rec[0, 10] = mat.clearcoat
        rec[0, 11] = mat.clearcoat_roughness
        rec[0, 12] = mat.subsurface
        rec[0, 13] = mat.alpha_cutoff
        rec[0, 14] = mat.blend_mode
        rec[0, 15:32] = meta_row
        uploads = [("mat_tex.rows", mm["cursor"], rows), ("mat_records", mid, rec)]
        mm["cursor"] = new_cursor
        return {"material_id": mid, "uploads": uploads, "lights": None, "instance_id": -1,
                "bvh_refit": False}

    def stream_material(self, arrays: SceneArrays, mat: Material) -> tuple[SceneArrays, int]:
        """``stage_material``'s plan written at once, in place; returns
        (``arrays``, the material id)."""
        plan = self.stage_material(mat)
        for f, o, r in plan["uploads"]:
            write_rows(pool_of(arrays, f), o, r)
        return arrays, plan["material_id"]

    def stream_instance(self, arrays: SceneArrays, segment_id: int, world: np.ndarray,
                        lod_band=(0.0, LOD_FAR), clip: int | None = None) -> SceneArrays:
        """``stage_instance``'s plan written at once, in place, with its
        lights; when the plan wires a parked TLAS slot, one refit then
        folds the new leaf into the BVH (its tensors rewritten in place
        too). Returns ``arrays``: every pool keeps its tensor."""
        plan = self.stage_instance(segment_id, world, lod_band, clip=clip)
        for f, o, r in plan["uploads"]:
            write_rows(pool_of(arrays, f), o, r)
        write_lights(arrays, plan["lights"])
        if plan["bvh_refit"]:
            bvh_ops.refit_bvh_in_place(arrays.bvh, arrays.positions, arrays.indices)
        return arrays

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
            has_hair=self._hair is not None,
            hair_vertex_base=self._hair_vertex_base(),
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
