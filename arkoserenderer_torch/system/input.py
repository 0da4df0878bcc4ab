"""Input state: keyboard, mouse and gamepad (port of
arkoserenderer_tpu/system/input.py).

Per-frame edge detection (pressed, held, released), mouse and scroll
deltas, and gamepad axes, as the reference's Input singleton
(arkose/system/Input.h:179-251). Sources push events (a web page, a replay
script, test code); consumers (camera controllers, the editor) poll. Host
numpy only: nothing here touches the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Input:
    def __post_init__(self):
        self._down: set[str] = set()
        self._pressed: set[str] = set()
        self._released: set[str] = set()
        self.mouse_pos = np.zeros(2, np.float32)
        self.mouse_delta = np.zeros(2, np.float32)
        self.scroll_delta = 0.0
        self.gamepad_left = np.zeros(2, np.float32)
        self.gamepad_right = np.zeros(2, np.float32)

    # -- event sources -------------------------------------------------------

    def push_key_down(self, key: str):
        key = key.lower()
        if key not in self._down:
            self._pressed.add(key)
        self._down.add(key)

    def push_key_up(self, key: str):
        key = key.lower()
        if key in self._down:
            self._released.add(key)
        self._down.discard(key)

    def push_mouse_move(self, x: float, y: float):
        new = np.array([x, y], np.float32)
        self.mouse_delta = self.mouse_delta + (new - self.mouse_pos)
        self.mouse_pos = new

    def push_scroll(self, dy: float):
        self.scroll_delta += dy

    def new_frame(self):
        """Clear the per-frame edges and deltas (Input::preEventPoll)."""
        self._pressed.clear()
        self._released.clear()
        self.mouse_delta = np.zeros(2, np.float32)
        self.scroll_delta = 0.0

    # -- queries ----------------------------------------------------------------

    def is_down(self, key: str) -> bool:
        return key.lower() in self._down

    def was_pressed(self, key: str) -> bool:
        return key.lower() in self._pressed

    def was_released(self, key: str) -> bool:
        return key.lower() in self._released

    def axis(self, pos_key: str, neg_key: str) -> float:
        return float(self.is_down(pos_key)) - float(self.is_down(neg_key))
