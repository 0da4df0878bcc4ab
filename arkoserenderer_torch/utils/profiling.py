"""Profiling: the frame record, scoped zones and whole-program traces (port
of arkoserenderer_tpu/utils/profiling.py, with the counterpart of the
reference's per-node GPU timestamps).

The frame record (``FrameRecord``) is upstream's timestamp queries around
every render node (VulkanBackend.cpp:1830-1935, read back a frame later
into AvgElapsedTimer): a pipeline owns one, an int64 ring of ``frames``
rows on its device, and every frame writes row ``frame_index % frames``:

  [0]                        the frame index (-1: no frame wrote the row)
  [1 .. passes + 1]          a timestamp before the first pass (the
                             frame's prologue and scene animation count to
                             the first pass) and after each pass, in the
                             order of ``pipeline.passes``, in ns
  [passes + 2 ..]            one value per counter of ``COUNTERS``

On the card a timestamp is the device's ``%globaltimer`` and each write is a
one-thread kernel (csrc/frame_record.cu); the row is chosen on the device
from the frame-index tensor, so a captured frame writes the record on every
replay with nothing read back. On the CPU the timestamps are the host's
``time.perf_counter_ns()``. The record is always on and writes only its own
ring. ``FrameRecord.rows()`` is its one readback.

The counters, each the frame's sum of what the passes count
(``FrameContext.count``):

  geometry.triangles     valid triangles of the scene's pool (Geometry)
  geometry.kept          opaque triangles that survive the camera's instance
                         frustum, LOD and meshlet culling (Geometry)
  raster.camera_dropped  bin entries the caps dropped, the camera's raster
  raster.camera_binned   bin entries kept: tile-list entries and the global
                         list's triangles, the camera's raster
  raster.sun_dropped     the same, the sun map's raster (SunShadow; 0 in a
  raster.sun_binned      frame that keeps a cached map)

Zones (``zone``) are upstream's SCOPED_PROFILE_ZONE (Profiling.h:8-66): a
rolling host wall-clock average per name, and, while a ``torch.profiler``
session records, a span (``record_function``) labelled ``name#<frame>``,
which the profiler nests in the enclosing zone's. The frame loop's zones:

  arkose.frame           Renderer.render_frame
    arkose.frame.scene     instance transforms and skinning uploads
    arkose.frame.camera    Camera.state, with its upload on a cache miss
    arkose.frame.capture   a CUDA-graph capture, labelled with the parts of
                           the graph's key no kept graph had
    arkose.frame.fill      the graph's input copies (state, scene, camera,
                           per-frame inputs, frame index, delta time)
    arkose.frame.replay    the graph's replay, or the per-pass chain's
    arkose.frame.exposure  auto-exposure's scalar readback

Each also leaves its milliseconds in the frame's host row of the record
(``FrameRecord.host``: the frame index, then one column a zone of
``HOST_ZONES``, NaN where the zone did not run), so the host stages of
frames rendered with no profiler read back beside their device times.

``trace`` records one session, of the CPU and, for a renderer on the card,
of CUDA, and writes it as a Chrome trace (``*.pt.trace.json``, for Perfetto
or TensorBoard) under ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

_ZONES: dict[str, list[float]] = collections.defaultdict(list)
ZONE_WINDOW = 60  # rolling samples per zone, like AvgElapsedTimer

COUNTERS = ("geometry.triangles", "geometry.kept", "raster.camera_dropped",
            "raster.camera_binned", "raster.sun_dropped", "raster.sun_binned")
HOST_ZONES = ("arkose.frame", "arkose.frame.scene", "arkose.frame.camera",
              "arkose.frame.capture", "arkose.frame.fill", "arkose.frame.replay",
              "arkose.frame.exposure")
RECORD_FRAMES = 2048  # ring rows: 127 s of frames at 62 ms
_LATEST: list = [None]  # the most recently made FrameRecord


@contextlib.contextmanager
def zone(name: str, frame: int | None = None, detail: str | None = None, record=None):
    """SCOPED_PROFILE_ZONE: times the block on the host's clock and, while a
    profiler records, names it as a span. The span's label is ``name``, then
    ``#<frame>`` and `` (<detail>)`` where given; both also go to
    ``record_function``'s args (torch's Chrome export drops a string
    argument, hence the label). The rolling average is kept under ``name``;
    with a ``record`` and a ``frame`` the time also goes to the frame's host
    row of that ``FrameRecord``."""
    t0 = time.perf_counter()
    if torch._C._autograd._profiler_enabled():
        label = name + ("" if frame is None else f"#{frame}")
        label += "" if detail is None else f" ({detail})"
        args = " ".join(x for x in ("" if frame is None else f"frame={frame}", detail or "")
                        if x) or None
        with torch.profiler.record_function(label, args):
            yield
    else:
        yield
    ms = (time.perf_counter() - t0) * 1e3
    samples = _ZONES[name]
    samples.append(ms)
    if len(samples) > ZONE_WINDOW:
        del samples[: len(samples) - ZONE_WINDOW]
    if record is not None and frame is not None:
        record.host_ms(frame, name, ms)


def zone_averages() -> dict[str, float]:
    """Rolling average ms per zone (AvgElapsedTimer::averageMs)."""
    return {k: sum(v) / len(v) for k, v in _ZONES.items() if v}


def reset_zones():
    _ZONES.clear()


class FrameRecord:
    """A pipeline's frame record (the module docstring has its layout):
    ``stamp`` and ``count`` write the frame's row, ``rows`` reads the ring
    back. Made outside any capture: the graphs write it by address."""

    def __init__(self, passes, device):
        self.passes = tuple(passes)
        self.counters = COUNTERS
        self.frames = RECORD_FRAMES
        self.counters_from = len(self.passes) + 2
        self.width = self.counters_from + len(COUNTERS)
        self.ring = torch.full((self.frames, self.width), -1, dtype=torch.int64, device=device)
        self.on_device = self.ring.device.type == "cuda"
        # The host's row a frame: [frame index, ms of each zone of HOST_ZONES].
        self.host = np.full((self.frames, 1 + len(HOST_ZONES)), np.nan)
        _LATEST[0] = self

    def _launch(self, fn: str, frame_index: torch.Tensor, *args) -> None:
        from arkoserenderer_torch.ops.raster_cuda import build_kernels

        fi = frame_index.to(self.ring.device, torch.int32)
        err = getattr(build_kernels(), fn)(
            self.ring.data_ptr(), fi.data_ptr(), self.frames, self.width, *args,
            torch.cuda.current_stream(self.ring.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{fn} failed: CUDA error {err}")

    def _row(self, frame_index: torch.Tensor) -> torch.Tensor:
        """(1,) the frame's row, as a tensor: nothing is read on the host."""
        return torch.remainder(frame_index.to(torch.int64), self.frames).reshape(1)

    def stamp(self, frame_index: torch.Tensor, boundary: int) -> None:
        """The timestamp of pass boundary ``boundary`` of the frame: 0
        before the first pass (it also writes the frame index and zeroes
        the counters), k after pass k."""
        slot = 1 + int(boundary)
        if self.on_device:
            self._launch("frame_stamp_launch", frame_index, slot, int(boundary == 0),
                         self.counters_from)
            return
        row = self._row(frame_index)
        if boundary == 0:
            self.ring[:, 0].index_copy_(0, row, frame_index.to(torch.int64).reshape(1))
            self.ring[:, self.counters_from:].index_fill_(0, row, 0)
        self.ring[:, slot].index_fill_(0, row, time.perf_counter_ns())

    def count(self, frame_index: torch.Tensor, name: str, value: torch.Tensor) -> None:
        """Add the 0-d integer tensor ``value`` to the frame's counter
        ``name``."""
        slot = self.counters_from + self.counters.index(name)
        if not self.on_device:
            self.ring[:, slot].index_add_(0, self._row(frame_index),
                                          value.to(torch.int64).reshape(1))
            return
        if value.dtype not in (torch.int32, torch.int64) or value.device != self.ring.device:
            value = value.to(self.ring.device, torch.int64)
        value = value.contiguous()
        self._launch("frame_count_launch", frame_index, slot, value.data_ptr(),
                     int(value.dtype == torch.int64))

    def host_ms(self, frame: int, name: str, ms: float) -> None:
        """Zone ``name``'s milliseconds in frame ``frame`` (a host int): the
        frame's first zone to end clears the row a frame before it left."""
        if name not in HOST_ZONES:
            return
        row = self.host[int(frame) % self.frames]
        if row[0] != frame:
            row[:] = np.nan
            row[0] = frame
        row[1 + HOST_ZONES.index(name)] = ms

    def rows(self) -> dict:
        """A host copy of the written rows, by frame index: ``frame_index``
        (n,), ``stamps_ns`` (n, passes + 1), ``counters`` {name: (n,)},
        ``host_ms`` {zone: (n,)} (NaN where the zone did not run in the
        frame or no zone wrote its host row), ``passes``, and ``clock`` ("globaltimer" on the card, else
        "perf_counter"). It waits for the device's writes."""
        ring = self.ring.cpu().numpy()
        ring = ring[ring[:, 0] >= 0]
        ring = ring[np.argsort(ring[:, 0], kind="stable")]
        host = self.host[ring[:, 0] % self.frames]
        host[host[:, 0] != ring[:, 0], 1:] = np.nan
        return {
            "frame_index": ring[:, 0].copy(),
            "stamps_ns": ring[:, 1:self.counters_from].copy(),
            "counters": {n: ring[:, self.counters_from + k].copy()
                         for k, n in enumerate(self.counters)},
            "host_ms": {n: host[:, 1 + k] for k, n in enumerate(HOST_ZONES)},
            "passes": list(self.passes),
            "clock": "globaltimer" if self.on_device else "perf_counter",
        }


def latest_frame_record() -> FrameRecord | None:
    """The most recently made pipeline's frame record, which outlives its
    pipeline: a tool may read a renderer's frames after releasing it."""
    return _LATEST[0]


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "arkose_torch_trace"),
          device="cuda"):
    """Record a trace of the block, CUDA included when ``device`` is a
    CUDA device, and write it under ``log_dir`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield log_dir
