"""RenderPipeline: the pass list and its frame function (port of
arkoserenderer_tpu/rendering/pipeline.py).

Two phases, as in the reference:

  * ``construct_all()`` — every pass declares its resources against a fresh
    Registry and returns its execute callback;
  * ``frame_fn()``      — runs the callbacks eagerly, in declared order, on
    the frame-state dict.

``compile()`` is the reference's jitted frame: on the card it captures the
whole ``frame_fn`` in CUDA graphs (``rendering/capture.py``) and returns a
callable with the reference's signature, ``fn(state, scene, camera_state,
frame_index, delta_time) -> state``, cached by ``donate_state``; on the CPU
it returns ``frame_fn`` itself. ``render_frame``, the entry point a frame
loop calls, goes through it on the card, unless a pass declares it cannot
be captured (``RenderPass.capture_blocker``), the pipeline renders a band
of a sharded frame (its collectives run on the host), or the caller is
inside ``eager_frames()``: then it runs ``frame_fn`` eagerly.
``validate_frame`` and per-pass timing (``pass_events``) run the eager
frame, as the reference times passes with its un-fused execute.

``FrameContext`` bundles what every execute callback receives: the scene
tensors, the camera state, the frame index (a 0-d int32 tensor on the
pipeline's device) and the frame's delta time (a 0-d float32 tensor), as
the reference's traced scalars, so nothing in a frame branches on them on
the host; whether this is frame 0 as the host knows it (``first_frame``,
for the one branch the host takes: the cached sun map's); and, under
pixel-band sharding (``parallel/sharded.py``), the band's first row in the
frame and its band group.

Every frame writes its row of the pipeline's frame record
(``utils/profiling.FrameRecord``, made by ``construct_all``): its index, a
timestamp before the first pass and after each pass, and the counters the
passes add through ``FrameContext.count``; eager, captured or replayed as
the per-pass chain alike.

``RenderPipeline.scene_animator``, when set, is the frame's prologue:
``fn(scene, frame_index, delta_time) -> scene`` runs before the first pass
and the passes see the scene it returns (the stress grid's animation).
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.core.types import RasterConfig, SceneLimits
from arkoserenderer_torch.rendering.registry import Registry
from arkoserenderer_torch.scene.camera import CameraState
from arkoserenderer_torch.scene.scene import SceneArrays, SceneStatic
from arkoserenderer_torch.utils.profiling import FrameRecord


class _FrameFields(NamedTuple):
    scene: SceneArrays
    camera: CameraState
    frame_index: torch.Tensor  # () int32
    delta_time: torch.Tensor   # () float32
    # Pixel-band sharding: the first frame row of this rank's band (a host
    # int, rank * band height) and the band group whose collectives join
    # the bands (``parallel.sharded.BandGroup``); 0 and None unsharded.
    row_offset: int = 0
    band: object = None
    first_frame: bool = False  # host: this is frame 0
    record: object = None  # the pipeline's FrameRecord (None: counts go nowhere)


class FrameContext(_FrameFields):
    """The frame's context. A host int ``frame_index`` becomes a 0-d int32
    tensor on the CPU, and a float ``delta_time`` a 0-d float32 one (torch
    takes 0-d CPU tensors beside tensors of any device); ``frame_fn`` makes
    them on the pipeline's device. ``first_frame`` defaults to
    ``frame_index == 0``, read on the host from a tensor index."""

    __slots__ = ()

    def __new__(cls, scene, camera, frame_index, delta_time=1 / 60, row_offset=0, band=None,
                first_frame=None, record=None):
        if not isinstance(frame_index, torch.Tensor):
            if first_frame is None:
                first_frame = int(frame_index) == 0
            frame_index = torch.tensor(int(frame_index), dtype=torch.int32)
        elif first_frame is None:
            first_frame = bool(frame_index == 0)
        if not isinstance(delta_time, torch.Tensor):
            delta_time = torch.tensor(float(delta_time), dtype=torch.float32)
        return super().__new__(cls, scene, camera, frame_index, delta_time, row_offset, band,
                               bool(first_frame), record)

    def count(self, name: str, value: torch.Tensor) -> None:
        """Add the 0-d integer tensor ``value`` to this frame's counter
        ``name`` (``utils.profiling.COUNTERS``) in the frame record, on the
        device: nothing is read back."""
        if self.record is not None:
            self.record.count(self.frame_index, name, value)


# The texture filters and sun-shadow taps the port takes; anisoN (N taps,
# "aniso" alone is 4) is matched by its prefix.
TEXTURE_QUALITIES = ("auto", "trilinear", "bilinear", "stochastic", "stochastic1", "sorted")
SHADOW_FILTERS = ("auto", "bilinear", "stochastic")


@dataclasses.dataclass
class PipelineConfig:
    """Static configuration shared by all passes. Every field of the
    reference's config, with its default, each value the reference takes
    ported; a reduced rate the reference's passes cannot run raises
    ``ValueError``."""

    width: int = 1920
    height: int = 1080
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    limits: SceneLimits = dataclasses.field(default_factory=SceneLimits)
    shadow_map_size: int = 2048
    local_shadow_map_size: int = 512  # each spot light's shadow map
    tonemap_mode: str = "agx"  # a key of ops.tonemap.MODES
    # Texture filter: "auto" (make_forward_pipeline resolves it to
    # "trilinear"), "trilinear" (8 taps), "bilinear" (the nearest mip, 4
    # taps), "anisoN" (N bilinear taps along the major gradient axis, e.g.
    # "aniso4"), "stochastic" / "stochastic1" (jittered taps that TAA
    # converges; they also turn on the temporal SSAO, MotionBlur, DoF and
    # SSSS branches) or "sorted" (trilinear on the packed path; the nearest
    # mip through the sorted tile gather, ops/texture.sample_bilinear_sorted,
    # under the reference shading mode). The reference shading mode takes
    # trilinear, bilinear and sorted ("auto" and "stochastic" are trilinear
    # there).
    texture_quality: str = "auto"
    # Deferred-shading path: "packed" (one record gather per pixel,
    # channel-packed material textures, VSM sun shadows) or "reference"
    # (ops/shading.shade_visibility_buffer: per-field gathers, the RGBA8
    # texture pool, PCF sun shadows).
    shading_mode: str = "packed"
    # TAA history filter: "catmull" (16-tap Catmull-Rom, sharp history) or
    # "bilinear" (4 taps).
    taa_filter: str = "catmull"
    # Sun shadow receiver filter: "auto" (resolved to "bilinear"),
    # "bilinear" or "stochastic" (one jittered nearest VSM tap).
    shadow_filter: str = "auto"
    # Texture LOD bias; negative when rendering below display resolution
    # (make_forward_pipeline sets log2(render / display) for upscaling).
    mip_bias: float = 0.0
    # Sky env-map fetch at 1/k resolution, bilinearly upsampled (SkyView;
    # any k > 1 whose multiples the frame's sides are, else full rate).
    sky_fetch_scale: int = 1
    # Ray-tracing rate of RTShadow and RTReflections: 1 traces a ray per
    # pixel, 2 one per 2x2 block, reconstructed by nearest depth (where the
    # sides are even and the frame is not banded; else 1).
    rt_scale: int = 1
    # DDGI probe sampling in LightingCompose at 1/k resolution, 1 or 2,
    # nearest-depth upsampled (where k divides the sides; else 1).
    ddgi_sample_scale: int = 1
    # Pixel-band sharding (parallel/sharded.py): with ``shard_axis`` set the
    # pipeline renders a horizontal band of a taller frame, ``height`` rows
    # of ``full_height``, one band a rank of ``shard_count``; the band's
    # place and the collectives come with each frame (FrameContext).
    shard_axis: str | None = None
    full_height: int | None = None
    shard_count: int = 1
    scene: SceneStatic = dataclasses.field(default_factory=SceneStatic)

    def __post_init__(self):
        q = self.texture_quality
        aniso = q.startswith("aniso") and (q[5:] == "" or q[5:].isdigit())
        if not aniso and q not in TEXTURE_QUALITIES:
            raise ValueError(f"unknown texture_quality {q!r}")
        if self.shading_mode not in ("packed", "reference"):
            raise ValueError(f"unknown shading_mode {self.shading_mode!r}")
        if self.shadow_filter not in SHADOW_FILTERS:
            raise ValueError(f"unknown shadow_filter {self.shadow_filter!r}")
        # The nearest-depth upsample doubles each side, so the reference's
        # passes break at any other reduced rate (a shape mismatch in the
        # frame); the port refuses it here.
        for field in ("rt_scale", "ddgi_sample_scale"):
            if getattr(self, field) not in (1, 2):
                raise ValueError(f"{field}={getattr(self, field)!r}: 1 or 2 (the "
                                 "nearest-depth upsample is 2x)")

    @property
    def frame_height(self) -> int:
        return self.full_height if self.full_height is not None else self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


ExecuteFn = Callable[[dict, FrameContext], dict]


class RenderPass(abc.ABC):
    """Base pass (RenderPipelineNode analogue)."""

    name: str = "UnnamedPass"
    # Why this pass's execute cannot run inside a captured frame
    # (``RenderPipeline.compile``), or None when it can. A pipeline with
    # such a pass runs its frames eagerly.
    capture_blocker: str | None = None

    @abc.abstractmethod
    def construct(self, cfg: PipelineConfig, reg: Registry,
                  device: torch.device) -> ExecuteFn:
        """Declare resources against ``reg``; return the execute callback.
        Constants the pass keeps live on ``device``."""

    def host_step(self, state: dict, first_frame: bool) -> tuple:
        """The host's share of this pass's frame, from the state's host
        values (the registry's dtype-None resources) and whether this is
        frame 0: (the branch the pass takes, None for a pass with one path;
        the host values it writes into the state). Its execute takes the
        same branch; a captured frame is one graph for each tuple of
        branches, and the host values come from here."""
        return None, {}

    def frame_inputs(self, frame_index: int) -> dict:
        """Host values this pass reads each frame as device inputs, for
        frame ``frame_index``: {resource: numpy array, or a tuple of them}.
        The frame reads them from the state; ``frame_fn`` uploads those the
        state lacks, and a captured frame copies them into its buffers."""
        return {}


class RenderPipeline:
    def __init__(self, cfg: PipelineConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.passes: list[RenderPass] = []
        self.registry = Registry()
        self._executes: list[tuple[str, ExecuteFn]] | None = None
        self.scene_animator: Callable | None = None
        self._compiled: dict = {}  # compile()'s frames by donate_state
        self.record: FrameRecord | None = None  # made by construct_all
        # The band group under pixel-band sharding (ShardedRenderer sets it).
        self.band = None

    def add_pass(self, p: RenderPass) -> "RenderPipeline":
        self.passes.append(p)
        return self

    def construct_all(self):
        """Run every pass's construct against a fresh Registry."""
        self.registry = Registry()
        self._executes = []
        for p in self.passes:
            self.registry.set_current_node(p.name)
            self._executes.append((p.name, p.construct(self.cfg, self.registry, self.device)))
        self.registry.set_current_node(None)
        self._compiled = {}  # the captured frames ran the old callbacks
        self._frame_input_names = list(self.frame_inputs(0))
        self.record = FrameRecord([p.name for p in self.passes], self.device)
        return self

    def _require_constructed(self):
        if self._executes is None:
            raise RuntimeError("call construct_all() first")

    def initial_state(self) -> dict:
        self._require_constructed()
        return self.registry.initial_state(self.device)

    def frame_inputs(self, frame_index: int) -> dict:
        """Every pass's ``frame_inputs`` for frame ``frame_index`` (host
        values, by resource)."""
        out = {}
        for p in self.passes:
            out.update(p.frame_inputs(int(frame_index)))
        return out

    def _prologue(self, state: dict, scene: SceneArrays, camera: CameraState, frame_index,
                  delta_time, first_frame: bool | None) -> tuple[dict, FrameContext]:
        """The frame's state (a copy, with the per-frame inputs it lacks
        uploaded) and context: the frame index and delta time as 0-d tensors
        on the pipeline's device (a host value is uploaded), the scene
        animated. It writes the frame record's first timestamp."""
        self._require_constructed()
        dev = self.device
        if not isinstance(frame_index, torch.Tensor):
            if first_frame is None:
                first_frame = int(frame_index) == 0
            frame_index = torch.tensor(int(frame_index), dtype=torch.int32, device=dev)
        self.record.stamp(frame_index, 0)
        if not isinstance(delta_time, torch.Tensor):
            delta_time = torch.tensor(float(delta_time), dtype=torch.float32, device=dev)
        state = dict(state)
        wanted = [k for k in self._frame_input_names if k not in state]
        if wanted:  # a tensor frame index is read here: pass the inputs to avoid it
            host = self.frame_inputs(int(frame_index))
            state.update({k: tree_map_host(host[k], dev) for k in wanted})
        if self.scene_animator is not None:
            scene = self.scene_animator(scene, frame_index, delta_time)
        ctx = FrameContext(scene=scene, camera=camera, frame_index=frame_index,
                           delta_time=delta_time, row_offset=self.row_offset, band=self.band,
                           first_frame=first_frame, record=self.record)
        return state, ctx

    def frame_fn(self, state: dict, scene: SceneArrays, camera: CameraState,
                 frame_index, delta_time=1 / 60, pass_events: list | None = None,
                 first_frame: bool | None = None) -> dict:
        """Run all passes in declared order, eagerly; returns the new state
        dict. ``frame_index`` and ``delta_time`` are host values or 0-d
        tensors on the pipeline's device; ``first_frame`` (whether this is
        frame 0) defaults to ``frame_index == 0``, read on the host from a
        tensor index. The per-frame inputs (``frame_inputs``) the state
        lacks are formed for the frame index and uploaded.

        ``pass_events``: when a list, each pass appends (name, start, end)
        CUDA events recorded around it, for a per-pass time table. The
        frame record takes a timestamp after each pass."""
        state, ctx = self._prologue(state, scene, camera, frame_index, delta_time, first_frame)
        for i, (name, execute) in enumerate(self._executes):
            if pass_events is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            updates = execute(state, ctx)
            if pass_events is not None:
                end.record()
                pass_events.append((name, start, end))
            self.record.stamp(ctx.frame_index, i + 1)
            if updates:
                state.update(updates)
        return state

    @property
    def capture_blockers(self) -> list[tuple[str, str]]:
        """(what, why) of each thing that keeps this pipeline's frame from
        a capture: the passes that declare a ``capture_blocker``, and a
        band of a sharded frame (its collectives run on the host)."""
        out = [(p.name, p.capture_blocker) for p in self.passes if p.capture_blocker]
        if self.band is not None:
            out.append(("pixel bands", "the band group's collectives run on the host"))
        return out

    def compile(self, donate_state: bool = True):
        """The frame as the reference's jitted ``frame_fn``: a callable
        ``fn(state, scene, camera_state, frame_index, delta_time) -> state``
        (``rendering/capture.CompiledFrame``: the whole frame captured in
        CUDA graphs, one for each branch the host takes, after a warm-up
        frame), cached by ``donate_state`` like the reference's: with
        donation the caller's persistent tensors are the graph's buffers,
        updated in place; without, the inputs are copied in and the outputs
        cloned out. A replay reuses its output buffers: a caller that keeps
        a frame's image copies it. On the CPU, where CUDA graphs do not
        exist, it returns ``frame_fn``, which takes the same inputs. Raises
        ``NotImplementedError`` naming what blocks a capture."""
        self._require_constructed()
        if self.device.type != "cuda":
            return self.frame_fn
        if self.capture_blockers:
            what, why = self.capture_blockers[0]
            raise NotImplementedError(f"{what} cannot be captured yet: {why}")
        from arkoserenderer_torch.rendering.capture import CompiledFrame

        key = bool(donate_state)
        if key not in self._compiled:
            self._compiled[key] = CompiledFrame(self, donate_state=key)
        return self._compiled[key]

    @property
    def captured(self) -> bool:
        """Whether ``render_frame`` goes through ``compile()``: on the card,
        with nothing blocking a capture, outside ``eager_frames()``."""
        return (self.device.type == "cuda" and not self.capture_blockers
                and not frames_run_eagerly())

    def describe(self) -> str:
        """The pass order and the registry's resource table."""
        head = " -> ".join(p.name for p in self.passes)
        return f"pipeline [{head}]\n{self.registry.describe()}"

    @property
    def row_offset(self) -> int:
        """The first frame row of this rank's band (0 unsharded)."""
        return 0 if self.band is None else self.band.rank * self.cfg.height

    def render_frame(self, state: dict, scene: SceneArrays, camera_state: CameraState,
                     frame_index: int, delta_time: float = 1 / 60,
                     pass_events: list | None = None) -> dict:
        """One frame from the persistent ``state``, the entry point a frame
        loop calls (``Renderer.render_frame`` does): through ``compile()``
        when ``captured``, else ``frame_fn`` eagerly. ``pass_events`` (a
        list) takes each pass's (name, start, end) CUDA events: the chain of
        per-pass graphs of the captured frame, or the eager frame's."""
        if self.captured:
            return self.compile()(state, scene, camera_state, frame_index, delta_time,
                                  pass_events=pass_events)
        return self.frame_fn(state, scene, camera_state, frame_index, delta_time,
                             pass_events=pass_events)


_EAGER_FRAMES = [0]


@contextlib.contextmanager
def eager_frames():
    """Within it every pipeline's ``render_frame`` runs ``frame_fn``
    eagerly: for tools that replace a kernel's wrapper to see or change each
    call (a replay calls no wrapper), and for eager-to-captured comparisons."""
    _EAGER_FRAMES[0] += 1
    try:
        yield
    finally:
        _EAGER_FRAMES[0] -= 1


def frames_run_eagerly() -> bool:
    """Whether the caller is within ``eager_frames()``."""
    return bool(_EAGER_FRAMES[0])


def tree_map_host(value, device):
    """A host value (a numpy array, or a tuple of them) as tensors on
    ``device``."""
    if isinstance(value, tuple):
        return tuple(tree_map_host(v, device) for v in value)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)


def _float_leaves(value, path: str = ""):
    """(path, tensor) of every floating tensor in a resource: a tensor, or
    the fields of a NamedTuple or dataclass (the raster setup, the BVH),
    nested; the paths read ".field"."""
    if isinstance(value, torch.Tensor):
        if value.is_floating_point():
            yield path, value
    elif hasattr(value, "_asdict"):
        for k, v in value._asdict().items():
            yield from _float_leaves(v, f"{path}.{k}")
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _float_leaves(getattr(value, f.name), f"{path}.{f.name}")


def validate_frame(pipeline: RenderPipeline, state: dict, scene: SceneArrays,
                   camera_state: CameraState, frame_index: int = 0,
                   delta_time: float = 1 / 60) -> list[dict]:
    """Run one frame a pass at a time and report every non-finite value a
    pass writes: one finding {pass, resource, non_finite, shape} for each
    floating tensor of each pass's updates that holds one, the resource
    named with its leaf's path ("vis.setup.screen_xy"). A debugging
    harness; an empty list is a clean frame."""
    state, ctx = pipeline._prologue(state, scene, camera_state, frame_index, delta_time, None)
    findings = []
    for i, (name, execute) in enumerate(pipeline._executes):
        updates = execute(state, ctx) or {}
        pipeline.record.stamp(ctx.frame_index, i + 1)
        for key, value in updates.items():
            for path, leaf in _float_leaves(value):
                bad = int((~torch.isfinite(leaf)).sum())
                if bad:
                    findings.append({"pass": name, "resource": key + path, "non_finite": bad,
                                     "shape": tuple(leaf.shape)})
        state.update(updates)
    return findings


def pixel_centers(cfg: PipelineConfig, device, step: int = 1):
    """(N,) px / (N,) py flattened pixel-centre coordinates of the band (of
    the frame, unsharded) on ``device``; add ``FrameContext.row_offset`` to
    py for frame rows. ``step`` > 1: the centres of the first pixel of each
    step x step block (i * step + 0.5), h // step by w // step of them,
    the samples of a reduced-rate pass."""
    xs = np.arange(cfg.width // step, dtype=np.float32) * step + 0.5
    ys = np.arange(cfg.height // step, dtype=np.float32) * step + 0.5
    px, py = np.meshgrid(xs, ys)
    return (torch.from_numpy(px.ravel()).to(device),
            torch.from_numpy(py.ravel()).to(device))


def frame_rows(py: torch.Tensor, ctx: FrameContext) -> torch.Tensor:
    """The band's pixel-centre rows ``py`` as rows of the whole frame."""
    return py + ctx.row_offset if ctx.row_offset else py
