"""Debug draw: host-accumulated 3D lines composited over the final image
(port of arkoserenderer_tpu/rendering/passes/debugdraw.py).

The host fills a ``DebugLineBuffer`` each frame (lines, boxes, a ground
grid, axes); its four arrays are the ``debug.lines`` input of the frame
(the pass's ``frame_inputs``: the pipeline uploads them, or a captured
frame copies them into its buffers). ``DebugDrawPass`` samples 64 points along each line,
projects them, depth-tests each against SceneDepth (with a 0.1 % bias, so
lines on a surface win) and writes the line's colour into LDR; where
samples share a pixel the later one wins (``overlay.scatter_last``).
"""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.rendering.passes.overlay import project, scatter_last
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry

MAX_LINES = 1024
SAMPLES_PER_LINE = 64


class DebugLineBuffer:
    """Host line accumulator; ``clear`` empties it."""

    def __init__(self, capacity: int = MAX_LINES):
        self.capacity = capacity
        self.clear()

    def clear(self):
        self._a = np.zeros((self.capacity, 3), np.float32)
        self._b = np.zeros((self.capacity, 3), np.float32)
        self._color = np.zeros((self.capacity, 3), np.float32)
        self.count = 0

    def line(self, a, b, color=(1.0, 1.0, 0.0)):
        """One line from ``a`` to ``b``; past the capacity it is dropped."""
        if self.count >= self.capacity:
            return
        i = self.count
        self._a[i] = a
        self._b[i] = b
        self._color[i] = color
        self.count += 1

    def box(self, mins, maxs, color=(0.2, 1.0, 0.2)):
        """The 12 edges of an axis-aligned box."""
        sel = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
        c = np.asarray(mins)[None, :] * (1.0 - sel) + np.asarray(maxs)[None, :] * sel
        for i, j in ((0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
                     (0, 4), (1, 5), (2, 6), (3, 7)):
            self.line(c[i], c[j], color)

    def grid(self, size: float = 10.0, step: float = 1.0, y: float = 0.0,
             color=(0.35, 0.35, 0.38)):
        """An editor ground grid at height ``y``."""
        n = int(size / step)
        for i in range(-n, n + 1):
            self.line((-size, y, i * step), (size, y, i * step), color)
            self.line((i * step, y, -size), (i * step, y, size), color)

    def axes(self, origin=(0, 0, 0), size=1.0):
        """Red x, green y and blue z axes from ``origin``."""
        o = np.asarray(origin, np.float32)
        self.line(o, o + [size, 0, 0], (1, 0.2, 0.2))
        self.line(o, o + [0, size, 0], (0.2, 1, 0.2))
        self.line(o, o + [0, 0, size], (0.2, 0.4, 1))

    def host_arrays(self) -> tuple:
        """(a, b, color, valid) as numpy copies: the frame's ``debug.lines``
        on the host."""
        valid = np.zeros((self.capacity,), np.float32)
        valid[:self.count] = 1.0
        return tuple(x.copy() for x in (self._a, self._b, self._color, valid))

    def arrays(self, device) -> tuple:
        """(a, b, color, valid) on ``device``: the frame's ``debug.lines``."""
        return tuple(torch.from_numpy(x).to(device) for x in self.host_arrays())


class DebugDrawPass(RenderPass):
    name = "DebugDraw"

    def __init__(self, buffer: DebugLineBuffer):
        self.buffer = buffer

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        reg.get("LDR")
        reg.get("SceneDepth")
        reg.publish("debug.lines")  # the host's input of each frame
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        # jnp.linspace(0, 1, 64)'s values: i * float32(1 / 63).
        t = torch.from_numpy(np.arange(SAMPLES_PER_LINE, dtype=np.float32)
                             * np.float32(1.0 / (SAMPLES_PER_LINE - 1))).to(device)[None, :, None]

        def execute(state: dict, ctx: FrameContext) -> dict:
            a, b, color, valid = state["debug.lines"]
            pts = (a[:, None, :] * (1 - t) + b[:, None, :] * t).reshape(-1, 3)
            xi, yi, d, ok = project(ctx.camera.view_proj, pts, w, full_h, ctx.row_offset)
            on = ok & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            on = on & (torch.repeat_interleave(valid, SAMPLES_PER_LINE) > 0)
            # Hidden behind the scene, with a slight bias so lines on a
            # surface win.
            scene_d = state["SceneDepth"].reshape(-1)[
                torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)]
            on = on & (d * 1.001 >= scene_d)
            cols = torch.repeat_interleave(color, SAMPLES_PER_LINE, dim=0)
            return {"LDR": scatter_last(state["LDR"], yi * w + xi, on, cols)}

        return execute

    def frame_inputs(self, frame_index: int) -> dict:
        return {"debug.lines": self.buffer.host_arrays()}
