"""The reader of ``shading.roofline_share`` on made-up traces: the least
time of a 1080p frame's shading (65 bytes a pixel over the peak bandwidth)
over the ``packed_shading_kernel`` time a traced frame, and nothing where
no such kernel ran, as a program without the kernel gives."""

import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib.spec import Spec  # noqa: E402
from perfbench.lib.trace import Trace  # noqa: E402
from perfbench.roofline import bounds  # noqa: E402

CONFIG = {"width": 1920, "height": 1080}


def read(kernels: list, frames: int):
    ev = [{"ph": "X", "cat": "kernel", "name": name, "ts": 100.0 * k, "dur": dur}
          for k, (name, dur) in enumerate(kernels)]
    ctx = types.SimpleNamespace(trace=Trace(ev), frames_traced=frames, config=CONFIG)
    reader, part = Spec().metric_reader("shading.roofline_share")
    return reader.read(ctx, part)


def test_the_share_of_the_kernel_time():
    # 2,073,600 pixels of 65 bytes: 134,784,000 bytes, 40.23 us at 3.35 TB/s.
    least_us = bounds.least_seconds(1920 * 1080 * 65) * 1e6
    assert abs(least_us - 134_784_000 / 3.35e12 * 1e6) < 1e-9
    kernels = [("void packed_shading_kernel<true, false>(Args)", 200.0)] * 3
    kernels += [("raster_tiles_kernel", 500.0), ("elementwise_kernel", 30.0)]
    assert abs(read(kernels, 3) - 100.0 * least_us / 200.0) < 1e-9


def test_no_kernel_reads_nothing():
    assert read([("raster_tiles_kernel", 500.0)], 3) is None
    assert read([], 3) is None
