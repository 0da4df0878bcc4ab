"""System layer: the window and surface interface and its headless
implementations (port of arkoserenderer_tpu/system/system.py).

The reference's arkose/system/System.h (+ SystemGlfw.cpp): window creation,
the event pump and the time source. The machine with the card has no
display server, so ``HeadlessSystem`` is the production implementation
(frames kept, and written to PNG files on request) and ``ReplaySystem``
feeds a recorded input script for deterministic sessions; the web viewer
(``system/webviewer.py``) is the interactive one.
"""

from __future__ import annotations

import abc
import time

import numpy as np
import torch

from arkoserenderer_torch.system.input import Input


class System(abc.ABC):
    """Abstract platform services (System.h)."""

    def __init__(self):
        self.input = Input()
        self._t0 = time.perf_counter()

    @abc.abstractmethod
    def create_window(self, width: int, height: int, title: str) -> None: ...

    @abc.abstractmethod
    def framebuffer_size(self) -> tuple[int, int]: ...

    @abc.abstractmethod
    def new_frame(self) -> bool:
        """Pump events; returns False when the app should exit."""

    def time_since_startup(self) -> float:
        return time.perf_counter() - self._t0

    @abc.abstractmethod
    def present(self, ldr_image) -> None:
        """Deliver the final frame (the swapchain's present)."""


def host_image(ldr_image) -> np.ndarray:
    """The LDR image as a host numpy array: one copy (``.cpu()``) of a
    tensor on any device; anything else through ``np.asarray``."""
    if isinstance(ldr_image, torch.Tensor):
        return ldr_image.cpu().numpy()
    return np.asarray(ldr_image)


class HeadlessSystem(System):
    """No display: the last frame is kept (and written to disk when
    ``out_path``, a format string with ``{frame}``, is given)."""

    def __init__(self, out_path: str | None = None, max_frames: int | None = None):
        super().__init__()
        self._size = (1280, 720)
        self.out_path = out_path
        self.max_frames = max_frames
        self.frame_count = 0
        self.last_frame = None

    def create_window(self, width: int, height: int, title: str) -> None:
        self._size = (width, height)

    def framebuffer_size(self) -> tuple[int, int]:
        return self._size

    def new_frame(self) -> bool:
        self.input.new_frame()
        return self.max_frames is None or self.frame_count < self.max_frames

    def present(self, ldr_image) -> None:
        self.last_frame = ldr_image
        if self.out_path:
            from arkoserenderer_torch.utils.imageio import save_png

            save_png(self.out_path.format(frame=self.frame_count), host_image(ldr_image))
        self.frame_count += 1


class ReplaySystem(HeadlessSystem):
    """Feeds a recorded input script: a list of (frame, Input method, args)."""

    def __init__(self, script, **kw):
        super().__init__(**kw)
        self.script = sorted(script, key=lambda e: e[0])
        self._cursor = 0

    def new_frame(self) -> bool:
        ok = super().new_frame()
        while (
            self._cursor < len(self.script)
            and self.script[self._cursor][0] <= self.frame_count
        ):
            _, method, args = self.script[self._cursor]
            getattr(self.input, method)(*args)
            self._cursor += 1
        return ok
