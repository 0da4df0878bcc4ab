"""Photographic camera (port of arkoserenderer_tpu/scene/camera.py).

``Camera`` is host numpy: matrices, EV100 exposure, Halton jitter and the
previous-frame matrices for motion vectors. ``Camera.state(frame, device)``
freezes it into a ``CameraState`` of tensors on the device — the
CameraState UBO analogue — with one host-to-device copy, cached while
nothing the state depends on changes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.halton import camera_jitter_sequence


class CameraState(NamedTuple):
    """Per-frame camera data as tensors."""

    view_from_world: torch.Tensor        # (4,4)
    proj_from_view: torch.Tensor         # (4,4) jittered
    unjittered_proj: torch.Tensor        # (4,4)
    prev_view_from_world: torch.Tensor   # (4,4)
    prev_proj_from_view: torch.Tensor    # (4,4) unjittered previous projection
    position: torch.Tensor               # (3,)
    exposure: torch.Tensor               # () pre-exposure multiplier
    jitter_px: torch.Tensor              # (2,)
    near: torch.Tensor                   # ()
    focus_depth: torch.Tensor            # ()
    aperture_px: torch.Tensor            # ()

    @property
    def view_proj(self):
        return self.proj_from_view @ self.view_from_world

    @property
    def unjittered_view_proj(self):
        return self.unjittered_proj @ self.view_from_world

    @property
    def prev_view_proj(self):
        return self.prev_proj_from_view @ self.prev_view_from_world


# Flat float32 layout of a CameraState (field, shape) for the single upload.
_STATE_LAYOUT = [(f, (4, 4)) for f in CameraState._fields[:5]] + [
    ("position", (3,)), ("exposure", ()), ("jitter_px", (2,)), ("near", ()),
    ("focus_depth", ()), ("aperture_px", ()),
]


def camera_state_from_arrays(fields: dict, device) -> CameraState:
    """CameraState from host arrays (one float32 buffer, one copy)."""
    flat = np.concatenate(
        [np.asarray(fields[name], np.float32).reshape(-1) for name, _ in _STATE_LAYOUT]
    )
    buf = torch.from_numpy(flat).to(device)
    out, o = {}, 0
    for name, shape in _STATE_LAYOUT:
        n = int(np.prod(shape))
        out[name] = buf[o:o + n].view(shape)
        o += n
    return CameraState(**out)


def calculate_ev100(f_number: float, shutter_speed: float, iso: float) -> float:
    return float(np.log2((f_number * f_number) / shutter_speed * 100.0 / iso))


def exposure_from_ev100(ev100: float) -> float:
    """H = 1 / (1.2 * 2^EV100) (reflected-light meter calibration)."""
    return 1.0 / (1.2 * (2.0 ** ev100))


@dataclasses.dataclass
class Camera:
    """Host camera; mutate freely between frames, call ``state()`` per frame."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    orientation: np.ndarray = dataclasses.field(  # quaternion (x,y,z,w)
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32)
    )
    viewport: tuple[int, int] = (1920, 1080)  # (width, height)

    focal_length_mm: float = 30.0
    sensor_size_mm: tuple[float, float] = (36.0, 24.0)
    f_number: float = 16.0
    shutter_speed: float = 1.0 / 400.0
    iso: float = 400.0
    exposure_compensation: float = 0.0
    adaption_rate: float = 0.0018  # auto-exposure eye adaption rate a frame

    focus_depth: float = 5.0  # meters
    near: float = 0.25
    far: float | None = None  # None = infinite far (reverse-Z)

    jitter_enabled: bool = True
    jitter_period: int = 16

    def __post_init__(self):
        self._jitter_seq = camera_jitter_sequence(self.jitter_period)
        self._prev_view: np.ndarray | None = None
        self._prev_proj: np.ndarray | None = None
        self._auto_exposure: float | None = None  # EV100 of update_auto_exposure
        self._state_cache: dict = {}

    def look_at(self, position, target, up=(0.0, 1.0, 0.0)):
        self.position = np.asarray(position, np.float32)
        view = mx.look_at(self.position, np.asarray(target, np.float32), up)
        self.orientation = mx.quat_from_mat3(view[:3, :3].T)

    @property
    def aspect_ratio(self) -> float:
        return self.viewport[0] / self.viewport[1]

    def field_of_view_x(self) -> float:
        return 2.0 * np.arctan(self.sensor_size_mm[0] / (2.0 * self.focal_length_mm))

    def set_field_of_view_x(self, fov_x: float):
        """Set the focal length that gives horizontal FOV ``fov_x`` (radians)."""
        self.focal_length_mm = self.sensor_size_mm[0] / (2.0 * np.tan(fov_x / 2.0))

    def field_of_view_y(self) -> float:
        half_x = np.tan(self.field_of_view_x() / 2.0)
        return 2.0 * np.arctan(half_x / self.aspect_ratio)

    def view_matrix(self) -> np.ndarray:
        rot = mx.quat_to_mat3(self.orientation.astype(np.float32)).T
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = -rot @ self.position
        return m

    def projection_matrix(self, jitter: tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
        proj = mx.perspective_reverse_z(
            self.field_of_view_y(), self.aspect_ratio, self.near, self.far
        )
        if jitter != (0.0, 0.0):
            proj = mx.apply_jitter(proj, jitter[0], jitter[1], *self.viewport)
        return proj

    def ev100(self) -> float:
        return calculate_ev100(self.f_number, self.shutter_speed, self.iso)

    def exposure(self) -> float:
        return exposure_from_ev100(self.ev100() - self.exposure_compensation)

    def update_auto_exposure(self, avg_luminance: float, delta_time: float) -> float:
        """Eye adaption: move the auto-exposure EV100 toward the metered
        luminance's (``adaption_rate`` a 60th of a second) and return the
        exposure it gives."""
        target_ev = float(np.log2(max(avg_luminance, 1e-4) * 100.0 / 12.5))
        cur = self._auto_exposure if self._auto_exposure is not None else target_ev
        rate = 1.0 - np.exp(-delta_time * self.adaption_rate * 60.0)
        self._auto_exposure = cur + (target_ev - cur) * rate
        return exposure_from_ev100(self._auto_exposure - self.exposure_compensation)

    def film_grain_gain(self) -> float:
        """The film grain's amount at this ISO (more grain at higher ISO)."""
        return 0.012 * float(np.sqrt(self.iso / 100.0))

    def coc_mm_to_px(self) -> float:
        return self.viewport[0] / self.sensor_size_mm[0]

    def aperture_diameter_mm(self) -> float:
        return self.focal_length_mm / self.f_number

    def host_state(self, frame_index: int = 0) -> dict:
        """Every CameraState field as host float32 arrays."""
        if self.jitter_enabled:
            j = self._jitter_seq[frame_index % self.jitter_period]
            jitter = (float(j[0]), float(j[1]))
        else:
            jitter = (0.0, 0.0)
        view = self.view_matrix()
        proj = self.projection_matrix(jitter)
        unjittered = self.projection_matrix()
        prev_view = self._prev_view if self._prev_view is not None else view
        prev_proj = self._prev_proj if self._prev_proj is not None else unjittered
        f_m = self.focal_length_mm / 1000.0
        aperture_px = (
            self.aperture_diameter_mm() * self.coc_mm_to_px() * f_m
            / max(self.focus_depth - f_m, 1e-4)
        )
        return dict(
            view_from_world=view, proj_from_view=proj, unjittered_proj=unjittered,
            prev_view_from_world=prev_view, prev_proj_from_view=prev_proj,
            position=np.asarray(self.position, np.float32),
            exposure=np.float32(self.exposure()),
            jitter_px=np.array(jitter, np.float32),
            near=np.float32(self.near),
            focus_depth=np.float32(self.focus_depth),
            aperture_px=np.float32(aperture_px),
        )

    def state(self, frame_index: int = 0, device="cuda") -> CameraState:
        """CameraState on ``device``; a static camera hits the cache after
        one jitter period and uploads nothing."""
        slot = (frame_index % self.jitter_period) if self.jitter_enabled else -1
        key = (
            str(device), self.position.tobytes(), self.orientation.tobytes(),
            tuple(self.viewport), self.focal_length_mm, tuple(self.sensor_size_mm),
            self.f_number, self.shutter_speed, self.iso,
            self.exposure_compensation, self.focus_depth, self.near,
            self.far, self.jitter_period, slot,
            None if self._prev_view is None else self._prev_view.tobytes(),
            None if self._prev_proj is None else self._prev_proj.tobytes(),
        )
        cached = self._state_cache.get(key)
        if cached is not None:
            return cached
        st = camera_state_from_arrays(self.host_state(frame_index), device)
        if len(self._state_cache) >= 4 * self.jitter_period:
            self._state_cache.clear()  # moving camera: bound the cache
        self._state_cache[key] = st
        return st

    def post_render(self):
        """Record previous-frame matrices."""
        self._prev_view = self.view_matrix()
        self._prev_proj = self.projection_matrix()

    def frustum_planes(self) -> np.ndarray:
        """(6, 4) inward planes (left, right, bottom, top, near, far) of the
        unjittered view-projection, host numpy (Gribb-Hartmann)."""
        r = self.projection_matrix() @ self.view_matrix()
        planes = np.stack([r[3] + r[0], r[3] - r[0], r[3] + r[1], r[3] - r[1], r[3] - r[2],
                           r[2]], axis=0)
        n = np.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
        return planes / np.maximum(n, 1e-20)
