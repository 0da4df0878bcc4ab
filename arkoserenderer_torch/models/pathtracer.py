"""The path tracer's host loop, the PathTracerApp analogue (port of
arkoserenderer_tpu/models/pathtracer.py: ``world_space_vertices`` and
``PathTracer``).

Owns the scene's two-level BVH, a persistent accumulation buffer on the
device and the progressive sampling loop: each ``render_sample`` adds one
``ops/pathtrace.trace_path`` sample a pixel under the key
``fold_in(PRNGKey(seed), sample_index)``, derived on the device. The
accumulation resets when the host moves the camera, and survives a process
restart through ``save_checkpoint`` / ``load_checkpoint``. Runs on the card
unless ``device`` asks for the CPU.

On the card one sample is a CUDA graph, the counterpart of the reference's
jitted ``step``: captured at the first sample after a warm-up trace on a
side stream, then replayed once a sample. Everything a sample reads is a
buffer the host fills between replays: the sample index (a 0-d int64), the
seed's key (rewritten by ``load_checkpoint``) and the camera state (copied
in at each ``render_sample``); the accumulation is one buffer, added to,
zeroed and loaded in place. A replay calls no kernel wrapper, so the
traversal's launches recorded by the capture are added to its counters at
every replay (``rendering/capture.add_launch_counts``). Within
``rendering.pipeline.eager_frames()``, and on the CPU, each sample runs
eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.core import prng
from arkoserenderer_torch.ops import tonemap as tm
from arkoserenderer_torch.ops.pathtrace import trace_path
from arkoserenderer_torch.ops.texture import linear_to_srgb
from arkoserenderer_torch.rendering import capture
from arkoserenderer_torch.rendering.pipeline import frames_run_eagerly
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.scene import Scene


def world_space_vertices(arrays) -> np.ndarray:
    """The vertex pool through each vertex's instance transform, on the
    host: (V, 3) float32."""
    pos = arrays.positions.cpu().numpy()
    inst = arrays.vertex_instance.cpu().numpy()
    w = arrays.world.cpu().numpy()[inst]
    return np.einsum("vij,vj->vi", w[:, :3, :3], pos) + w[:, :3, 3]


class PathTracer:
    """Progressive path tracing of ``scene`` through ``camera`` at
    ``width`` x ``height``. ``aa=False`` samples the exact pixel centres:
    the truth harness's mode, in which the raster frame and the tracer
    shade the same surface points."""

    def __init__(self, scene: Scene, camera: Camera, width: int, height: int,
                 max_bounces: int = 3, tonemap_mode: str = "agx", seed: int = 0,
                 aa: bool = True, device="cuda"):
        self.scene = scene
        self.camera = camera
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        self.aa = aa
        self.device = torch.device(device)
        self.arrays = scene.build(self.device, with_bvh=True)
        self.bvh = self.arrays.bvh
        xs = torch.arange(width, dtype=torch.float32, device=self.device) + 0.5
        ys = torch.arange(height, dtype=torch.float32, device=self.device) + 0.5
        pyg, pxg = torch.meshgrid(ys, xs, indexing="ij")
        self._px = pxg.reshape(-1)
        self._py = pyg.reshape(-1)
        self._mode = tm.MODES[tonemap_mode]
        self._seed = seed
        self.accum = torch.zeros((height * width, 3), dtype=torch.float32, device=self.device)
        self.sample_count = 0
        self._cam_sig = None
        # A sample's inputs: the seed's key, the sample index, the camera.
        self._key = prng.device_key(seed, self.device)
        self._index = torch.zeros((), dtype=torch.int64, device=self.device)
        self._cam = None
        self._graph = None      # the captured sample
        self._graph_of = None   # the scene arrays it was captured on
        self._graph_launches = None
        # The lights' static shape: NEE per light, which cast shadows, and
        # the soft sources (the sun's disk, the lights' radii).
        self._lights = dict(
            n_spots=len(scene.spots), n_points=len(scene.points),
            spot_casters=tuple(bool(s.cast_shadows) for s in scene.spots),
            point_casters=tuple(bool(getattr(p, "cast_shadows", False)) for p in scene.points),
            sun_cos_radius=(float(np.cos(np.radians(getattr(scene.sun, "angular_radius_deg", 0.0))))
                            if scene.sun is not None else 1.0),
            spot_source_radius=tuple(float(getattr(s, "source_radius", 0.0)) for s in scene.spots),
            point_source_radius=tuple(float(getattr(p, "source_radius", 0.0))
                                      for p in scene.points),
        )

    @property
    def captured(self) -> bool:
        """Whether a sample replays the captured graph: on the card, outside
        ``eager_frames()``."""
        return self.device.type == "cuda" and not frames_run_eagerly()

    def _trace(self) -> torch.Tensor:
        """One sample a pixel from the buffers alone (no host value)."""
        key = prng.fold_in(self._key, self._index)
        return trace_path(self.arrays, self.bvh, self._cam, self._px, self._py, self.width,
                          self.height, key, self.max_bounces, aa=self.aa, **self._lights)

    def _sample(self) -> None:
        self.accum.add_(self._trace())

    def _capture(self) -> None:
        """Capture ``_sample`` after a warm-up trace on a side stream, whose
        result is dropped (it builds the kernels and their attributes); the
        warm-up's and the capture's launches are taken back out of the
        counters."""
        dev = self.device
        before = capture.launch_counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._trace()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        at_capture = capture.launch_counts()
        with torch.cuda.graph(graph):
            self._sample()
        self._graph_launches = capture.count_delta(capture.launch_counts(), at_capture)
        capture.set_launch_counts(before)
        self._graph, self._graph_of = graph, self.arrays

    def _step(self) -> None:
        """One sample, index ``sample_count``, added into ``accum``."""
        self._index.fill_(self.sample_count)
        if not self.captured:
            self._sample()
            return
        if self._graph is None or self._graph_of is not self.arrays:
            self._capture()
        self._graph.replay()
        capture.add_launch_counts(self._graph_launches)

    def _camera_signature(self):
        return (tuple(np.asarray(self.camera.position).ravel().tolist()),
                tuple(np.asarray(self.camera.orientation).ravel().tolist()),
                self.camera.focal_length_mm)

    def reset(self):
        self.accum.zero_()
        self.sample_count = 0

    def render_sample(self, n_samples: int = 1) -> torch.Tensor:
        """Add ``n_samples`` samples a pixel (after a reset if the camera
        moved since the last call); returns ``radiance()``."""
        sig = self._camera_signature()
        if sig != self._cam_sig:
            self._cam_sig = sig
            self.reset()
        cam_state = self.camera.state(0, self.device)
        if self._cam is None:
            self._cam = capture.tree_map(torch.clone, cam_state)
        else:
            capture.copy_leaves(self._cam, cam_state)
        for _ in range(n_samples):
            self._step()
            self.sample_count += 1
        return self.radiance()

    def save_checkpoint(self, path: str):
        """The accumulation, the sample count and the seed, to an .npz."""
        np.savez_compressed(path, accum=self.accum.cpu().numpy(),
                            count=np.array([self.sample_count, self._seed], np.int64))

    def load_checkpoint(self, path: str):
        z = np.load(path)
        self.accum.copy_(torch.from_numpy(z["accum"]))
        self.sample_count = int(z["count"][0])
        self._seed = int(z["count"][1])
        self._key.copy_(prng.device_key(self._seed, self.device))
        self._cam_sig = self._camera_signature()  # the next sample does not reset

    def radiance(self) -> torch.Tensor:
        """(H, W, 3) mean pre-exposed radiance so far."""
        n = max(self.sample_count, 1)
        return (self.accum / n).reshape(self.height, self.width, 3)

    def ldr(self) -> torch.Tensor:
        c = tm.tonemap(torch.clamp(self.radiance(), min=0.0), self._mode)
        return torch.clamp(linear_to_srgb(c), 0.0, 1.0)
