"""Carry the reference package's parameters across to the port.

The reference's ``SceneArrays`` and ``CameraState`` are NamedTuples of
arrays; with every field passed through ``np.asarray`` they become the
inputs of the functions below, which rebuild the port's tuples on a
device. The tests use them to feed one scene, one camera and one frame
state to both packages. Every array is copied, never aliased: an ``np.asarray`` view of
a reference array may share its buffer, which a later frame can recycle.

Nested tuples (``materials``, ``lights`` with its spot, point and IES lanes,
``mat_tex``) may be given as NamedTuples of arrays, as mappings, or
flattened to "lights.sun_view_proj" style keys; the morph tuples (one array
per morphed instance) flatten to "morph_pos.0" style keys; the BVH
flattens to "bvh.*" keys: a two-level one (a dataclass in both packages;
its wide fields may be None, which adds no key) carries across as the port's
``TwoLevelBVH``, a flat one (a NamedTuple: ``build_bvh``'s, or the one-leaf
placeholder of a scene without one) as the port's ``FlatBVH``. The
skinning pools, the palette and the RGBA8 texture pool (``textures``, which
the path tracer samples; its uint32 texels become int32 with the same bits)
and the hair strands carry across too.

``frame_state_from_numpy`` carries a frame state across: every resource a
pass published (``ShadowMap.locals``, the G-buffer, the refitted
``scene.bvh``, ...) and the persistent ones (``TAAHistory``, the cached sun
map, the DDGI atlases), so a reference frame can seed a frame of the port.
``probe_grid_from`` and ``ddgi_state_from_numpy`` carry a DDGI grid and a
``DDGIState`` across, so both packages start from the same probes.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from arkoserenderer_torch.ops.bvh import FlatBVH, bvh_from_host
from arkoserenderer_torch.ops.ddgi import DDGIState, ProbeGridConfig
from arkoserenderer_torch.ops.raster import TriSetup
from arkoserenderer_torch.scene.camera import CameraState, camera_state_from_arrays
from arkoserenderer_torch.scene.scene import SceneArrays, scene_arrays_from_host


def numpy_fields(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten NamedTuples / dataclasses / mappings of arrays to
    {"a.b": np.ndarray}, plain tuples and lists to {"a.0": ...}; a None
    field (a scene's absent BVH) adds no key."""
    if tree is None:
        return {}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_asdict"):
        tree = {str(i): v for i, v in enumerate(tree)}
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
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
    become tensors, the raster setup NamedTuple the port's ``TriSetup``, a
    BVH (a two-level dataclass, or a flat NamedTuple) the port's, and the
    scene-version counters host ints."""
    out = {}
    for k, v in state.items():
        if k in HOST_STATE_KEYS:
            out[k] = int(np.asarray(v))
        elif dataclasses.is_dataclass(v) or getattr(v, "_fields", None) == FlatBVH._fields:
            out[k] = bvh_from_host(numpy_fields(v), device)
        elif hasattr(v, "_fields"):
            out[k] = TriSetup(*(torch.from_numpy(np.array(x, copy=True)).to(device) for x in v))
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out


def probe_grid_from(grid) -> ProbeGridConfig:
    """The port's ProbeGridConfig with every field of ``grid`` (the
    reference's, or any object with those attributes)."""
    return ProbeGridConfig(**{f.name: getattr(grid, f.name)
                              for f in dataclasses.fields(ProbeGridConfig)})


def ddgi_state_from_numpy(state, device) -> DDGIState:
    """The port's DDGIState on ``device`` from the reference's (a
    NamedTuple or a mapping of irradiance, visibility and offsets)."""
    fields = numpy_fields(state)
    return DDGIState(*(torch.from_numpy(fields[k]).to(device) for k in DDGIState._fields))
