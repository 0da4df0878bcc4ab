"""Profiling: scoped zones and whole-program traces (port of
arkoserenderer_tpu/utils/profiling.py).

The reference's Tracy integration (arkcore/utility/Profiling.h:8-66, the
SCOPED_PROFILE_ZONE macros, and TracyVk's GPU zones): ``zone`` keeps a
rolling host wall-clock average per label and names its span in a
``torch.profiler`` trace (``record_function``); ``trace`` records one, of
the CPU and, for a renderer on the card, of CUDA, and writes it as a
Chrome trace (``*.pt.trace.json``, for Perfetto or TensorBoard) under
``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time

import torch

_ZONES: dict[str, list[float]] = collections.defaultdict(list)
ZONE_WINDOW = 60  # rolling samples per zone, like AvgElapsedTimer


@contextlib.contextmanager
def zone(name: str):
    """SCOPED_PROFILE_ZONE: times the block on the host's clock and names
    it in a trace being recorded."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    samples = _ZONES[name]
    samples.append((time.perf_counter() - t0) * 1e3)
    if len(samples) > ZONE_WINDOW:
        del samples[: len(samples) - ZONE_WINDOW]


def zone_averages() -> dict[str, float]:
    """Rolling average ms per zone (AvgElapsedTimer::averageMs)."""
    return {k: sum(v) / len(v) for k, v in _ZONES.items() if v}


def reset_zones():
    _ZONES.clear()


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
