"""Device memory statistics and a rolling history (port of
arkoserenderer_tpu/utils/memstats.py): the allocator's bytes in use and
their peak (``torch.cuda.memory_stats``) against the card's total memory
(``torch.cuda.mem_get_info``). A CPU device has no such statistics and
reads zeros, as the reference's CPU device does. ``format()`` keeps the
reference's "HBM" wording.
"""

from __future__ import annotations

import collections
import dataclasses

import torch


@dataclasses.dataclass
class MemSnapshot:
    bytes_in_use: int
    bytes_limit: int
    peak_bytes_in_use: int

    @property
    def used_fraction(self) -> float:
        return self.bytes_in_use / self.bytes_limit if self.bytes_limit else 0.0


def snapshot(device="cuda") -> MemSnapshot:
    """The memory of ``device`` now; zeros on a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return MemSnapshot(bytes_in_use=0, bytes_limit=0, peak_bytes_in_use=0)
    stats = torch.cuda.memory_stats(device)
    return MemSnapshot(
        bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
        bytes_limit=int(torch.cuda.mem_get_info(device)[1]),
        peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
    )


class MemHistory:
    """Rolling memory usage history (the VRAM plot's data source)."""

    def __init__(self, window: int = 120):
        self._hist: collections.deque[MemSnapshot] = collections.deque(maxlen=window)

    def poll(self, device="cuda") -> MemSnapshot:
        s = snapshot(device)
        self._hist.append(s)
        return s

    def history_mb(self) -> list[float]:
        return [s.bytes_in_use / 1e6 for s in self._hist]

    def format(self) -> str:
        if not self._hist:
            return "no samples"
        s = self._hist[-1]
        return (
            f"HBM {s.bytes_in_use / 1e6:.1f} / {s.bytes_limit / 1e6:.1f} MB "
            f"({s.used_fraction * 100:.1f}%), peak {s.peak_bytes_in_use / 1e6:.1f} MB"
        )
