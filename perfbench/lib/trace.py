"""The traced stretch's reading: ``torch.profiler`` over whole-frame replays,
exported as a Chrome trace to a temporary file, read back and deleted.

Device operations are the trace's kernels, copies and sets. The traced span
runs from the first device operation's start to the last one's end; the
busy time is the union of the operations' intervals within it, and an idle
gap is named by the harness's span (``perfbench.*``) and the host call
that were running when the gap began."""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: list[dict]):
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            row = (float(e["ts"]), float(e["dur"]), str(e.get("name", "")))
            if cat in DEVICE_CATS:
                dev.append(row + (cat,))
            elif cat in HOST_CATS:
                host.append(row + (cat,))
        dev.sort()
        host.sort()
        self.device_ops = dev  # (start us, duration us, name, category)
        self.host_ops = host
        self.kernels = [d for d in dev if d[3] == "kernel"]
        self.merged = self._merge([(s, s + d) for s, d, _, _ in dev])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @staticmethod
    def _merge(intervals):
        out = []
        for s, e in sorted(intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def window_us(self) -> float:
        return self.merged[-1][1] - self.merged[0][0] if self.merged else 0.0

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.merged)

    def kernel_us(self, fragment: str) -> float:
        """Device time of the kernels whose name holds ``fragment``."""
        return sum(d for _, d, name, _ in self.kernels if fragment in name)

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for _, d, name, _ in self.device_ops:
            key = name[:120]
            by[key] = by.get(key, 0.0) + d
        return [[k, v * 1e-6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def host_at(self, t: float) -> str:
        """The harness span and the innermost host call running at ``t``."""
        span, call = "", ""
        for s, d, name, cat in self.host_ops:
            if s > t:
                break
            if s + d >= t:
                if cat == "user_annotation" and name.startswith("perfbench."):
                    span = name
                elif cat in ("cuda_runtime", "cuda_driver"):
                    call = name
        return "/".join(x for x in (span, call) if x) or "host"

    def idle_gaps(self, n: int = 10) -> list:
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(self.merged, self.merged[1:])]
        gaps.sort(reverse=True)
        return [[self.host_at(t), g * 1e-6] for g, t in gaps[:n]]
