"""Carry the reference package's parameters across to the port.

The reference's ``SceneArrays`` and ``CameraState`` are NamedTuples of
arrays; with every field passed through ``np.asarray`` they become the
inputs of the functions below, which rebuild the port's tuples on a
device. The tests use them to feed one scene, one camera and one frame
state to both packages. Every array is copied, never aliased: an ``np.asarray`` view of
a reference array may share its buffer, which a later frame can recycle.

Nested tuples (``materials``, ``lights`` with its spot, point and IES lanes,
``mat_tex``) may be given as NamedTuples of arrays, as mappings, or
flattened to "lights.sun_view_proj" style keys. Fields the port does not
carry (skinning, BVH, ...) are ignored.

``frame_state_from_numpy`` carries a frame state across: every resource a
pass published (``ShadowMap.locals``, the G-buffer, ...) and the persistent
ones (``TAAHistory``, the cached sun map), so a reference frame can seed a
frame of the port.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from arkoserenderer_torch.ops.raster import TriSetup
from arkoserenderer_torch.scene.camera import CameraState, camera_state_from_arrays
from arkoserenderer_torch.scene.scene import SceneArrays, scene_arrays_from_host


def numpy_fields(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten NamedTuples / mappings of arrays to {"a.b": np.ndarray}."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(numpy_fields(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.array(tree, copy=True)}


def scene_arrays_from_numpy(fields: Mapping, device) -> SceneArrays:
    """The port's SceneArrays on ``device`` from the reference's fields."""
    return scene_arrays_from_host(numpy_fields(fields), device)


def camera_state_from_numpy(fields: Mapping, device) -> CameraState:
    """The port's CameraState on ``device`` from the reference's fields."""
    return camera_state_from_arrays(numpy_fields(fields), device)


# Frame-state entries the port keeps on the host as Python ints.
HOST_STATE_KEYS = ("scene.version", "SunShadow.version")


def frame_state_from_numpy(state: Mapping, device) -> dict:
    """The port's frame state on ``device`` from the reference's: arrays
    become tensors, the raster setup NamedTuple the port's ``TriSetup``, and
    the scene-version counters host ints."""
    out = {}
    for k, v in state.items():
        if k in HOST_STATE_KEYS:
            out[k] = int(np.asarray(v))
        elif hasattr(v, "_fields"):
            out[k] = TriSetup(*(torch.from_numpy(np.array(x, copy=True)).to(device) for x in v))
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out
