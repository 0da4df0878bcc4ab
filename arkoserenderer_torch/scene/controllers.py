"""Camera controllers: FPS (WASD + mouse) and map-style orbit, pan and zoom
(port of arkoserenderer_tpu/scene/controllers.py).

The reference's arkose/scene/camera/{FpsCameraController,
MapCameraController}: each frame they read the ``Input`` state and drive
the host ``Camera`` with smoothed motion. Host numpy, in the reference's
operations and dtypes, so both packages move the camera bit for bit alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.system.input import Input


@dataclasses.dataclass
class FpsCameraController:
    """WASD + mouse-look with velocity smoothing."""

    camera: Camera
    move_speed: float = 4.0
    look_speed: float = 0.0025
    smoothing: float = 12.0

    def __post_init__(self):
        self._velocity = np.zeros(3, np.float32)
        self._yaw = 0.0
        self._pitch = 0.0
        # Initial yaw and pitch from the camera's orientation.
        fwd = mx.np_quat_rotate(self.camera.orientation, np.array([0, 0, -1.0], np.float32))
        self._yaw = float(np.arctan2(-fwd[0], -fwd[2]))
        self._pitch = float(np.arcsin(np.clip(fwd[1], -1, 1)))

    def update(self, input: Input, dt: float):
        cam = self.camera
        # Mouse-look is always on, as in the reference (its right-button
        # test is or-ed with True).
        if input.is_down("mouse_right") or True:
            self._yaw -= input.mouse_delta[0] * self.look_speed
            self._pitch = float(np.clip(
                self._pitch - input.mouse_delta[1] * self.look_speed,
                -1.5, 1.5,
            ))
        qy = mx.quat_from_axis_angle(np.array([0, 1.0, 0]), self._yaw)
        qp = mx.quat_from_axis_angle(np.array([1.0, 0, 0]), self._pitch)
        cam.orientation = np.asarray(mx.quat_mul(qy, qp), np.float32)

        wish = np.array([
            input.axis("d", "a"),
            input.axis("e", "q"),
            input.axis("s", "w"),
        ], np.float32)
        n = np.linalg.norm(wish)
        if n > 1e-5:
            wish = wish / n * self.move_speed
        wish_world = mx.np_quat_rotate(cam.orientation, wish)
        k = 1.0 - np.exp(-self.smoothing * dt)
        self._velocity = self._velocity + (wish_world - self._velocity) * k
        cam.position = (cam.position + self._velocity * dt).astype(np.float32)


@dataclasses.dataclass
class MapCameraController:
    """Orbit, pan and zoom around a focus point (MapCameraController)."""

    camera: Camera
    focus: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    distance: float = 10.0
    yaw: float = 0.0
    pitch: float = -0.7
    zoom_speed: float = 0.12

    def update(self, input: Input, dt: float):
        if input.is_down("mouse_left"):
            self.yaw -= input.mouse_delta[0] * 0.005
            self.pitch = float(np.clip(self.pitch - input.mouse_delta[1] * 0.005, -1.5, -0.05))
        if input.is_down("mouse_middle"):
            # Pan in the camera's horizontal plane.
            right = mx.np_quat_rotate(self.camera.orientation, np.array([1.0, 0, 0], np.float32))
            fwd = np.cross(np.array([0, 1.0, 0], np.float32), right)
            pan = (-input.mouse_delta[0] * right + input.mouse_delta[1] * fwd)
            self.focus = (self.focus + pan * self.distance * 0.002).astype(np.float32)
        self.distance *= float(np.exp(-input.scroll_delta * self.zoom_speed))
        self.distance = float(np.clip(self.distance, 0.1, 1e4))

        cp = np.cos(self.pitch)
        offset = np.array([
            np.sin(self.yaw) * cp, -np.sin(self.pitch), np.cos(self.yaw) * cp,
        ], np.float32) * self.distance
        self.camera.look_at(self.focus + offset, self.focus)
