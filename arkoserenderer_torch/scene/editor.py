"""Editor: selection, transform gizmo math and scene hierarchy operations
(port of arkoserenderer_tpu/scene/editor.py).

The reference's editor layer (arkose/scene/editor/EditorScene.h:11-41, the
selected object; EditorGizmo.h:10-28, ImGuizmo's translate, rotate and
scale): editor logic independent of any UI toolkit. A front end (the web
viewer, a notebook, a terminal) calls it with pick results and drags.
Host numpy over ``Scene.instances``, whose entries here are (segment id,
world, previous world, LOD band): the animation clip the reference keeps
in the tuple lives in ``Scene.instance_clips``.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np

from arkoserenderer_torch.core import mathx as mx


class GizmoMode(Enum):
    TRANSLATE = "translate"
    ROTATE = "rotate"
    SCALE = "scale"


@dataclasses.dataclass
class EditorScene:
    """Selection and object manipulation over a host Scene."""

    scene: object  # scene.Scene

    def __post_init__(self):
        self.selected: int | None = None  # instance index
        self.gizmo_mode = GizmoMode.TRANSLATE

    # -- selection -----------------------------------------------------------

    def select_from_pick(self, pick_result: dict):
        """Take a ``Renderer.pick()`` result as the selection (PickingNode ->
        editor selection)."""
        inst = pick_result.get("instance", -1)
        self.selected = inst if inst >= 0 else None
        return self.selected

    def selected_transform(self) -> np.ndarray | None:
        if self.selected is None:
            return None
        return self.scene.instances[self.selected][1]

    # -- manipulation -------------------------------------------------------------

    def set_transform(self, world: np.ndarray):
        """Set the selection's world transform; the old one becomes its
        previous world (the frame's motion vectors)."""
        if self.selected is None:
            raise ValueError("no instance is selected")
        sid, old, _prev, lod_band = self.scene.instances[self.selected]
        self.scene.instances[self.selected] = (sid, np.asarray(world, np.float32), old, lod_band)

    def translate(self, delta):
        t = self.selected_transform()
        if t is None:
            raise ValueError("no instance is selected")
        new = t.copy()
        new[:3, 3] += np.asarray(delta, np.float32)
        self.set_transform(new)

    def rotate(self, axis, angle: float):
        t = self.selected_transform()
        if t is None:
            raise ValueError("no instance is selected")
        q = mx.quat_from_axis_angle(np.asarray(axis, np.float32), angle)
        r = np.asarray(mx.quat_to_mat3(q))
        new = t.copy()
        new[:3, :3] = r @ t[:3, :3]
        self.set_transform(new)

    def scale(self, factor: float):
        t = self.selected_transform()
        if t is None:
            raise ValueError("no instance is selected")
        new = t.copy()
        new[:3, :3] *= factor
        self.set_transform(new)

    def delete_selected(self):
        """Remove the selected instance (the scene must be built again)."""
        if self.selected is None:
            raise ValueError("no instance is selected")
        self.scene.instances.pop(self.selected)
        self.selected = None


def gizmo_axis_drag(
    camera,
    axis_world: np.ndarray,
    object_pos: np.ndarray,
    mouse_from: np.ndarray,
    mouse_to: np.ndarray,
) -> float:
    """Translate-gizmo math: project a screen drag (pixels) onto a world
    axis and return the world distance along it (ImGuizmo's translate)."""
    vp = camera.projection_matrix() @ camera.view_matrix()

    def to_screen(p):
        clip = mx.np_transform_points_h(vp, p[None])[0]
        w = max(abs(clip[3]), 1e-8)
        return np.array([
            (clip[0] / w * 0.5 + 0.5) * camera.viewport[0],
            (0.5 - clip[1] / w * 0.5) * camera.viewport[1],
        ])

    a0 = to_screen(object_pos)
    a1 = to_screen(object_pos + axis_world)
    axis_screen = a1 - a0
    denom = float(axis_screen @ axis_screen)
    if denom < 1e-8:
        return 0.0  # the axis points at the camera
    drag = np.asarray(mouse_to, np.float32) - np.asarray(mouse_from, np.float32)
    return float(drag @ axis_screen) / denom
