"""Skeletons and keyframe animation, evaluated on the host (port of
arkoserenderer_tpu/scene/animation.py, op for op in numpy).

Typed keyframe channels (step, linear, cubic spline) drive joint local TRS
or morph weights; joint world matrices are composed through the parent
chain and multiplied by the inverse-bind matrices into the skinning
palette, which the frame uploads for ``ops/skinning.skin_vertices``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from arkoserenderer_torch.core import mathx as mx

INTERP_STEP = 0
INTERP_LINEAR = 1
INTERP_CUBICSPLINE = 2


@dataclasses.dataclass
class Skeleton:
    """Joint hierarchy in bind pose (SkeletonAsset analogue)."""

    parents: np.ndarray          # (J,) i32, -1 = root; topologically sorted
    inverse_bind: np.ndarray     # (J, 4, 4)
    rest_translation: np.ndarray # (J, 3)
    rest_rotation: np.ndarray    # (J, 4) quat xyzw
    rest_scale: np.ndarray       # (J, 3)

    @property
    def num_joints(self) -> int:
        return len(self.parents)


@dataclasses.dataclass
class AnimChannel:
    """One sampler+target (AnimationAsset channel analogue)."""

    target_joint: int            # joint index (or -1 for morph weights)
    path: str                    # "translation" | "rotation" | "scale" | "weights"
    times: np.ndarray            # (K,)
    values: np.ndarray           # (K, C) — C=3/4/3/num_morphs
    interpolation: int = INTERP_LINEAR


@dataclasses.dataclass
class AnimationClip:
    channels: list[AnimChannel]
    name: str = ""

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)), default=0.0)


def sample_channel(ch: AnimChannel, t: float) -> np.ndarray:
    """Evaluate one channel at time t (clamped)."""
    times = ch.times
    k = len(times)
    if ch.interpolation == INTERP_CUBICSPLINE:
        # glTF cubic spline stores triplets (in-tangent, value, out-tangent).
        vals = ch.values.reshape(k, 3, -1)
        if t <= times[0]:
            return vals[0, 1]
        if t >= times[-1]:
            return vals[-1, 1]
        i = int(np.searchsorted(times, t, side="right") - 1)
        dt = times[i + 1] - times[i]
        u = (t - times[i]) / dt if dt > 0 else 0.0
        p0, m0 = vals[i, 1], vals[i, 2] * dt
        p1, m1 = vals[i + 1, 1], vals[i + 1, 0] * dt
        u2, u3 = u * u, u * u * u
        return (
            (2 * u3 - 3 * u2 + 1) * p0 + (u3 - 2 * u2 + u) * m0
            + (-2 * u3 + 3 * u2) * p1 + (u3 - u2) * m1
        )
    if t <= times[0]:
        return ch.values[0]
    if t >= times[-1]:
        return ch.values[-1]
    i = int(np.searchsorted(times, t, side="right") - 1)
    if ch.interpolation == INTERP_STEP:
        return ch.values[i]
    dt = times[i + 1] - times[i]
    u = (t - times[i]) / dt if dt > 0 else 0.0
    a, b = ch.values[i], ch.values[i + 1]
    if ch.path == "rotation":
        qa = a / np.linalg.norm(a)
        qb = b / np.linalg.norm(b)
        return np.asarray(mx.quat_slerp(qa, qb, u))
    return a + (b - a) * u


def evaluate_pose(
    skeleton: Skeleton, clip: AnimationClip | None, t: float, loop: bool = True
):
    """Returns (palette (J,4,4) = joint_world @ inverse_bind, morph_weights
    or None). ``t`` wraps by clip duration when looping (Animation's
    looping/one-shot modes)."""
    j = skeleton.num_joints
    trans = skeleton.rest_translation.copy()
    rot = skeleton.rest_rotation.copy()
    scl = skeleton.rest_scale.copy()
    morph = None

    if clip is not None:
        d = clip.duration
        if loop and d > 0:
            t = t % d
        for ch in clip.channels:
            v = sample_channel(ch, t)
            if ch.path == "translation":
                trans[ch.target_joint] = v
            elif ch.path == "rotation":
                rot[ch.target_joint] = v / np.linalg.norm(v)
            elif ch.path == "scale":
                scl[ch.target_joint] = v
            elif ch.path == "weights":
                morph = np.asarray(v, np.float32)

    local = np.zeros((j, 4, 4), np.float32)
    for i in range(j):
        local[i] = mx.compose_trs(trans[i], rot[i], scl[i])

    world = np.zeros_like(local)
    for i in range(j):  # parents sorted before children
        p = skeleton.parents[i]
        world[i] = local[i] if p < 0 else world[p] @ local[i]

    palette = np.einsum("jab,jbc->jac", world, skeleton.inverse_bind)
    return palette.astype(np.float32), morph


def topo_sort_joints(parents: np.ndarray):
    """Returns (order, remap) so that parents always precede children."""
    j = len(parents)
    order = []
    visited = np.zeros(j, bool)

    def visit(i):
        if visited[i]:
            return
        p = parents[i]
        if p >= 0:
            visit(p)
        visited[i] = True
        order.append(i)

    for i in range(j):
        visit(i)
    order = np.array(order, np.int32)
    remap = np.zeros(j, np.int32)
    remap[order] = np.arange(j, dtype=np.int32)
    return order, remap
