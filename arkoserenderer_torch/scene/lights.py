"""Lights with photometric units (port of arkoserenderer_tpu/scene/lights.py).

A directional sun in lux, spot lights in candela with an inner and outer
cone (optionally an IES polar profile and a mapped shadow), and point
lights. The host builds every light matrix in numpy; ``build_light_arrays``
returns host arrays that ``Scene.build`` moves to the device as
``LightArrays``, local lights in fixed-capacity lanes with their counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx


@dataclasses.dataclass
class DirectionalLight:
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.3, -1.0, 0.2], np.float32)
    )
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    illuminance_lux: float = 90000.0
    cast_shadows: bool = True
    angular_radius_deg: float = 0.0

    def normalized_direction(self) -> np.ndarray:
        d = np.asarray(self.direction, np.float32)
        return d / np.linalg.norm(d)

    def shadow_view_proj(self, scene_center: np.ndarray, scene_radius: float) -> np.ndarray:
        """Ortho light camera enclosing the scene bounds."""
        d = self.normalized_direction()
        eye = scene_center - d * (scene_radius * 2.0)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        if abs(np.dot(d, up)) > 0.98:
            up = np.array([1.0, 0.0, 0.0], np.float32)
        view = mx.look_at(eye, scene_center, up)
        r = float(scene_radius)
        proj = mx.orthographic_reverse_z(
            -r, r, -r, r, scene_radius * 0.5, scene_radius * 4.0
        )
        return proj @ view


@dataclasses.dataclass
class SpotLight:
    position: np.ndarray
    direction: np.ndarray
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    luminous_intensity_cd: float = 1000.0
    inner_cone_angle: float = np.radians(20.0)
    outer_cone_angle: float = np.radians(30.0)
    cast_shadows: bool = True
    ies_lut: np.ndarray | None = None  # (256,) polar intensity
    source_radius: float = 0.0  # world units, for soft ray-traced shadows

    def shadow_view_proj(self, far: float, near: float = 0.05) -> np.ndarray:
        """Perspective light camera covering the outer cone."""
        d = np.asarray(self.direction, np.float32)
        d = d / np.linalg.norm(d)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        if abs(np.dot(d, up)) > 0.98:
            up = np.array([1.0, 0.0, 0.0], np.float32)
        pos = np.asarray(self.position, np.float32)
        view = mx.look_at(pos, pos + d, up)
        fov = min(2.0 * float(self.outer_cone_angle) * 1.05, np.pi * 0.95)
        return mx.perspective_reverse_z(fov, 1.0, near, far=far) @ view


@dataclasses.dataclass
class PointLight:
    position: np.ndarray
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    luminous_intensity_cd: float = 1000.0
    cast_shadows: bool = False  # ray-traced only: there is no point-shadow atlas
    source_radius: float = 0.0


class LightArrays(NamedTuple):
    """Light data as tensors (the LightData SSBO analogue)."""

    sun_direction: torch.Tensor      # (3,)
    sun_color: torch.Tensor          # (3,) color * lux * exposure
    sun_valid: torch.Tensor          # () bool
    sun_view_proj: torch.Tensor      # (4,4) shadow matrix
    sun_cos_radius: torch.Tensor     # ()
    spot_pos: torch.Tensor           # (S,3)
    spot_dir: torch.Tensor           # (S,3)
    spot_color: torch.Tensor         # (S,3)
    spot_cone: torch.Tensor          # (S,2)
    spot_count: torch.Tensor         # () i32
    point_pos: torch.Tensor          # (P,3)
    point_color: torch.Tensor        # (P,3)
    point_count: torch.Tensor        # () i32
    ambient_lx: torch.Tensor         # ()
    spot_ies: torch.Tensor           # (S, 256)
    spot_view_proj: torch.Tensor     # (S, 4, 4)
    spot_casts_shadow: torch.Tensor  # (S,)


def build_light_arrays(
    sun: DirectionalLight | None,
    spots: list[SpotLight],
    points: list[PointLight],
    exposure: float,
    scene_center: np.ndarray,
    scene_radius: float,
    max_spots: int = 16,
    max_points: int = 16,
    ambient_lx: float = 0.0,
) -> dict[str, np.ndarray]:
    """Host arrays of every LightArrays field; intensities times ``exposure``."""
    if len(spots) > max_spots or len(points) > max_points:
        raise ValueError("local light capacity exceeded")
    if sun is not None:
        sun_dir = sun.normalized_direction()
        sun_color = sun.color * sun.illuminance_lux * exposure
        sun_vp = sun.shadow_view_proj(scene_center, scene_radius)
        sun_cos_r = np.cos(np.radians(sun.angular_radius_deg))
    else:
        sun_dir = np.array([0, -1, 0], np.float32)
        sun_color = np.zeros(3, np.float32)
        sun_vp = np.eye(4, dtype=np.float32)
        sun_cos_r = 1.0
    spot_pos = np.zeros((max_spots, 3), np.float32)
    spot_dir = np.tile(np.array([0, -1, 0], np.float32), (max_spots, 1))
    spot_color = np.zeros((max_spots, 3), np.float32)
    spot_cone = np.ones((max_spots, 2), np.float32)
    spot_ies = np.ones((max_spots, 256), np.float32)
    spot_vp = np.tile(np.eye(4, dtype=np.float32), (max_spots, 1, 1))
    spot_casts = np.zeros((max_spots,), np.float32)
    for i, s in enumerate(spots):
        spot_pos[i] = s.position
        d = np.asarray(s.direction, np.float32)
        spot_dir[i] = d / np.linalg.norm(d)
        spot_color[i] = s.color * s.luminous_intensity_cd * exposure
        spot_cone[i] = (np.cos(s.inner_cone_angle), np.cos(s.outer_cone_angle))
        if s.ies_lut is not None:
            spot_ies[i] = np.asarray(s.ies_lut, np.float32)
        spot_vp[i] = s.shadow_view_proj(far=max(scene_radius * 4.0, 1.0))
        spot_casts[i] = 1.0 if s.cast_shadows else 0.0

    point_pos = np.zeros((max_points, 3), np.float32)
    point_color = np.zeros((max_points, 3), np.float32)
    for i, p in enumerate(points):
        point_pos[i] = p.position
        point_color[i] = p.color * p.luminous_intensity_cd * exposure

    return dict(
        sun_direction=np.asarray(sun_dir, np.float32),
        sun_color=sun_color.astype(np.float32),
        sun_valid=np.asarray(sun is not None),
        sun_view_proj=np.asarray(sun_vp, np.float32),
        sun_cos_radius=np.asarray(sun_cos_r, np.float32),
        spot_pos=spot_pos,
        spot_dir=spot_dir,
        spot_color=spot_color,
        spot_cone=spot_cone,
        spot_count=np.asarray(len(spots), np.int32),
        point_pos=point_pos,
        point_color=point_color,
        point_count=np.asarray(len(points), np.int32),
        ambient_lx=np.asarray(ambient_lx * exposure, np.float32),
        spot_ies=spot_ies,
        spot_view_proj=spot_vp,
        spot_casts_shadow=spot_casts,
    )
