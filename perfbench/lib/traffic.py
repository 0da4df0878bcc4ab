"""The one traffic generator: what changes from frame to frame, read from a
mix's parameters (``traffic/<mix>.json``) and drawn from ``--seed``.

A mix has a ``camera`` (``{"kind": "static"}``, or ``{"kind":
"triangle_pan", "axis": [x, y, z], "step_m": s, "half_period": H,
"bob_m": b, "bob_rate": r}``: the camera slides ``s`` metres a frame along
``axis``, ``H`` frames one way and ``H`` back, a triangle wave of
``s * H / 2`` metres either side of where the scene put it, and bobs
``b * sin(r * k)`` up and down) and optionally an ``animation``
(``{"offset_frames": N}``: the scene's own animation runs with its clock
started ``N`` frames or fewer in). The seed sets the phase of both: every
seed gets the same path and the same animation, entered at another frame."""

from __future__ import annotations

import numpy as np


class Traffic:
    def __init__(self, mix: dict, seed: int):
        rng = np.random.default_rng(int(seed) % (1 << 64))  # any whole number, sign too
        self.camera = dict(mix.get("camera", {"kind": "static"}))
        kind = self.camera["kind"]
        if kind not in ("static", "triangle_pan"):
            raise ValueError(f"unknown camera kind {kind!r}")
        period = 2 * int(self.camera.get("half_period", 1))
        self.phase = int(rng.integers(period)) if kind == "triangle_pan" else 0
        anim = mix.get("animation")
        self.anim_offset = None if anim is None else int(rng.integers(anim["offset_frames"] + 1))
        self.base = None

    def offset(self, k: int) -> np.ndarray:
        """The camera's displacement at frame ``k`` from where the scene put it."""
        c = self.camera
        if c["kind"] == "static":
            return np.zeros(3, np.float32)
        h = int(c["half_period"])
        j = (k + self.phase) % (2 * h)
        along = float(c["step_m"]) * ((j if j < h else 2 * h - j) - h / 2)
        axis = np.asarray(c["axis"], np.float64)
        out = axis * along
        out[1] += float(c.get("bob_m", 0.0)) * np.sin(float(c.get("bob_rate", 0.0)) * (k + self.phase))
        return out.astype(np.float32)

    def bind(self, camera) -> None:
        """Remember where the scene put ``camera``: the path's origin."""
        self.base = np.array(camera.position, np.float32)

    def place(self, camera, k: int) -> None:
        """Put ``camera`` where frame ``k`` sees from."""
        camera.position = (self.base + self.offset(k)).astype(np.float32)

    def animator(self, animate):
        """``animate(arrays, frame_index, delta_time)`` with its clock
        started ``anim_offset`` frames in (the frame index stays the frame's)."""
        if self.anim_offset is None:
            return animate
        off = self.anim_offset

        def shifted(arrays, frame_index, delta_time):
            return animate(arrays, frame_index + off, delta_time)

        return shifted
