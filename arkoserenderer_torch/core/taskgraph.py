"""Host job system: thread pools, parallel-for and pollable tasks (port of
arkoserenderer_tpu/core/taskgraph.py).

Two pools, made at first use (or by ``initialize``): the default pool for
frame-critical host work and a background pool for asset preparation
(decode, import, upload staging). The work here is host code: a prepare
function running on a worker touches no CUDA tensor, so the frame loop's
thread alone issues the device work and its order stays deterministic.
"""

from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import os
import threading
from typing import Any, Callable, Iterable

_DEFAULT: _fut.ThreadPoolExecutor | None = None
_BACKGROUND: _fut.ThreadPoolExecutor | None = None
_LOCK = threading.Lock()


def initialize(default_workers: int | None = None, background_workers: int = 2):
    """Make the pools (one worker a CPU core by default); a no-op once
    they exist."""
    global _DEFAULT, _BACKGROUND
    with _LOCK:
        if _DEFAULT is None:
            n = default_workers or max(os.cpu_count() or 1, 1)
            _DEFAULT = _fut.ThreadPoolExecutor(n, thread_name_prefix="arkose-task")
        if _BACKGROUND is None:
            _BACKGROUND = _fut.ThreadPoolExecutor(background_workers,
                                                  thread_name_prefix="arkose-bg")


def shutdown():
    """Wait for the pools' work and drop them."""
    global _DEFAULT, _BACKGROUND
    with _LOCK:
        if _DEFAULT:
            _DEFAULT.shutdown(wait=True)
            _DEFAULT = None
        if _BACKGROUND:
            _BACKGROUND.shutdown(wait=True)
            _BACKGROUND = None


def _pool(background: bool) -> _fut.ThreadPoolExecutor:
    if _DEFAULT is None or _BACKGROUND is None:
        initialize()
    return _BACKGROUND if background else _DEFAULT  # type: ignore[return-value]


def schedule_task(fn: Callable, *args, background: bool = False) -> _fut.Future:
    """Run ``fn(*args)`` on a pool; returns its Future."""
    return _pool(background).submit(fn, *args)


def wait_for_completion(futures: Iterable[_fut.Future]):
    """Wait for every future, raising the first stored exception."""
    for f in list(futures):
        f.result()


def parallel_for(count: int, fn: Callable[[int], Any], min_batch: int = 1):
    """``fn(i)`` for i in range(count) across the default pool (inline when
    ``count <= min_batch`` or the pool has one worker)."""
    if count <= 0:
        return
    pool = _pool(False)
    if count <= min_batch or pool._max_workers <= 1:
        for i in range(count):
            fn(i)
        return
    wait_for_completion([pool.submit(fn, i) for i in range(count)])


def parallel_for_batched(count: int, fn: Callable[[int, int], Any], batch: int = 64):
    """``fn(start, end)`` over contiguous chunks of ``batch`` across the
    default pool."""
    if count <= 0:
        return
    pool = _pool(False)
    wait_for_completion([pool.submit(fn, s, min(s + batch, count))
                         for s in range(0, count, batch)])


@dataclasses.dataclass
class PollableTask:
    """An asynchronous task whose progress the caller polls."""

    future: _fut.Future
    _progress: float = 0.0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @classmethod
    def run(cls, fn: Callable[["PollableTask"], Any], background: bool = True):
        """Start ``fn(task)`` on a pool; ``fn`` reports through
        ``task.set_progress``."""
        task = cls.__new__(cls)
        task._progress = 0.0
        task._lock = threading.Lock()
        task.future = _pool(background).submit(fn, task)
        return task

    def set_progress(self, p: float):
        with self._lock:
            self._progress = float(p)

    def progress(self) -> float:
        with self._lock:
            return self._progress

    def done(self) -> bool:
        return self.future.done()

    def result(self):
        return self.future.result()
