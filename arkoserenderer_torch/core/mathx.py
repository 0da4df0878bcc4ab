"""3D math (port of arkoserenderer_tpu/core/mathx.py).

Two halves, kept apart:

  * host numpy (camera and light matrices, scene build): the same
    operations in the same dtypes as the reference's ``xp=np`` path, so
    both packages produce bit-identical host matrices;
  * torch tensor helpers used on the frame path.

Conventions: right-handed world, +Y up, camera looks down -Z; column
vectors (``p' = M @ p``); clip depth is reverse-Z (near 1, far 0); screen
space is x right, y down, pixel centres at integer + 0.5.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host numpy


def np_normalize(v, eps: float = 1e-20):
    return v / np.sqrt(np.sum(v * v, axis=-1, keepdims=True) + eps)


def quat_to_mat3(q):
    x, y, z, w = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_mat3(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s, 0.25 * s],
            np.float32,
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4, np.float32)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q / np.linalg.norm(q)


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def quat_from_axis_angle(axis, angle) -> np.ndarray:
    axis = np_normalize(np.asarray(axis, dtype=np.float32))
    half = 0.5 * np.asarray(angle, dtype=np.float32)
    return np.concatenate([axis * np.sin(half), np.cos(half)[..., None]], axis=-1)


def quat_mul(a, b) -> np.ndarray:
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_slerp(a, b, t) -> np.ndarray:
    """Spherical interpolation of unit quaternions, the shorter arc; a
    normalised lerp where they nearly coincide."""
    cos_half = np.sum(a * b, axis=-1, keepdims=True)
    b = np.where(cos_half < 0.0, -b, b)
    cos_half = np.minimum(np.abs(cos_half), 1.0 - 1e-7)
    half = np.arccos(cos_half)
    sin_half = np.sin(half)
    wa = np.sin((1.0 - t) * half) / sin_half
    wb = np.sin(t * half) / sin_half
    near = cos_half > 1.0 - 1e-5
    return np_normalize(np.where(near, (1.0 - t) * a + t * b, wa * a + wb * b))


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    return np.diag(np.concatenate([s, np.ones((1,), np.float32)]))


def rotation(q) -> np.ndarray:
    return compose_trs(np.zeros(3, np.float32), q, np.ones(3, np.float32))


def compose_trs(t, r, s) -> np.ndarray:
    """translation @ rotation @ scale, the glTF node order."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_mat3(r) * np.asarray(s, dtype=np.float32)[None, :]
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """View matrix (world -> view), camera at eye looking at target."""
    eye = np.asarray(eye, dtype=np.float32)
    f = np_normalize(np.asarray(target, dtype=np.float32) - eye)
    r = np_normalize(np.cross(f, np.asarray(up, dtype=np.float32)))
    u = np.cross(r, f)
    rot = np.stack([r, u, -f], axis=0)  # rows: view axes in world space
    t = -(rot @ eye)
    top = np.concatenate([rot, t[:, None]], axis=1)
    bottom = np.asarray([[0.0, 0.0, 0.0, 1.0]], dtype=np.float32)
    return np.concatenate([top, bottom], axis=0)


def perspective_reverse_z(fov_y, aspect, near, far=None) -> np.ndarray:
    """Perspective projection with reversed [0, 1] depth (near 1, far 0);
    ``far=None`` is the infinite-far variant. Clip +Y is up."""
    g = 1.0 / np.tan(0.5 * float(fov_y))
    if far is None:
        m22, m23 = 0.0, near
    else:
        m22 = near / (far - near)
        m23 = far * near / (far - near)
    return np.asarray(
        [
            [g / aspect, 0.0, 0.0, 0.0],
            [0.0, g, 0.0, 0.0],
            [0.0, 0.0, m22, m23],
            [0.0, 0.0, -1.0, 0.0],
        ],
        dtype=np.float32,
    )


def orthographic_reverse_z(left, right, bottom, top, near, far) -> np.ndarray:
    """Ortho projection with reversed [0, 1] depth."""
    return np.asarray(
        [
            [2.0 / (right - left), 0.0, 0.0, -(right + left) / (right - left)],
            [0.0, 2.0 / (top - bottom), 0.0, -(top + bottom) / (top - bottom)],
            [0.0, 0.0, 1.0 / (far - near), far / (far - near)],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def apply_jitter(proj, jitter_x, jitter_y, width: int, height: int) -> np.ndarray:
    """Add a sub-pixel jitter (pixels, y-down screen space) to a projection."""
    delta = np.asarray(
        [
            [0.0, 0.0, -2.0 * jitter_x / width, 0.0],
            [0.0, 0.0, 2.0 * jitter_y / height, 0.0],
            [0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
        ],
        dtype=np.float32,
    )
    return proj + delta


def np_quat_rotate(q, v) -> np.ndarray:
    """Rotate vector(s) v by quaternion(s) q (the host controllers' and the
    gizmo's; ``quat_rotate`` is the tensor version)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def np_transform_points_h(m, p) -> np.ndarray:
    """(4, 4) @ (N, 3) homogeneous -> (N, 4) clip positions, on the host."""
    r = p @ np.swapaxes(m[..., :3, :3], -1, -2) + m[..., None, :3, 3]
    w = p @ m[..., 3, :3] + m[..., None, 3, 3]
    return np.concatenate([r, w[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Tensors


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)


def vdot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Reflect ``incident`` about ``normal``."""
    return incident - 2.0 * vdot(incident, normal) * normal


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``q``, stored (x, y, z, w)."""
    qv = q[..., :3].expand_as(v)
    t = 2.0 * torch.cross(qv, v, dim=-1)
    return v + q[..., 3:4] * t + torch.cross(qv, t, dim=-1)


def apply_rows(mats: torch.Tensor, p: torch.Tensor, translate: bool = True) -> torch.Tensor:
    """(N, 3, 4) (or (N, 3, 3) without ``translate``) per-row matrices applied
    to (N, 3) vectors, row by row, elementwise: the affine transform with
    the fourth column, else the linear part (+ 0.0, so -0.0 lanes read +0.0)."""
    lanes = []
    for r in range(3):
        v = mats[:, r, 0] * p[:, 0] + mats[:, r, 1] * p[:, 1] + mats[:, r, 2] * p[:, 2]
        lanes.append(v + mats[:, r, 3] if translate else v + 0.0)
    return torch.stack(lanes, dim=-1)


def transform_point_lanes(m: torch.Tensor, p: torch.Tensor, rows=(0, 1, 2, 3)):
    """(4,4) m, (N,3) p -> tuple of (N,) homogeneous lanes for ``rows``."""
    return tuple(
        p[:, 0] * m[r, 0] + p[:, 1] * m[r, 1] + p[:, 2] * m[r, 2] + m[r, 3]
        for r in rows
    )


def transform_points_h(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(4,4) @ (N,3) homogeneous -> (N,4) clip positions."""
    r = p @ m[:3, :3].T + m[None, :3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return torch.cat([r, w[:, None]], dim=-1)


def frustum_planes_from_matrix(view_proj: torch.Tensor) -> torch.Tensor:
    """6 inward frustum planes (nx, ny, nz, d) of a reverse-Z view-proj
    (Gribb-Hartmann): left, right, bottom, top, near, far."""
    r = view_proj
    planes = torch.stack(
        [r[3] + r[0], r[3] - r[0], r[3] + r[1], r[3] - r[1], r[3] - r[2], r[2]],
        dim=0,
    )
    n = torch.linalg.norm(planes[:, :3], dim=-1, keepdim=True)
    return planes / torch.clamp(n, min=1e-20)


def frustum_test_spheres(planes: torch.Tensor, centers: torch.Tensor,
                         radii: torch.Tensor) -> torch.Tensor:
    """(6,4) planes vs (N,3) centres + (N,) radii -> (N,) bool visible."""
    d = centers @ planes[:, :3].T + planes[None, :, 3]
    return torch.all(d >= -radii[:, None], dim=-1)


def onb(n: torch.Tensor):
    """Branchless orthonormal basis of unit vectors (Frisvad, by Duff et
    al.): (..., 3) -> (tangent, bitangent), each (..., 3)."""
    s = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = torch.cat([1.0 + s * n[..., 0:1] ** 2 * a, s * b, -s * n[..., 0:1]], dim=-1)
    bt = torch.cat([b, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], dim=-1)
    return t, bt


def sample_cone(axis: torch.Tensor, cos_max, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform solid-angle direction inside the cone of half-angle
    acos(``cos_max``) around the unit ``axis`` (..., 3); ``u1``, ``u2``
    (...,) uniforms. ``cos_max`` 1 gives the axis exactly."""
    t, b = onb(axis)
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * np.pi * u2
    d = (t * (torch.cos(phi) * sin_t)[..., None] + b * (torch.sin(phi) * sin_t)[..., None]
         + axis * cos_t[..., None])
    return normalize(d)


def sample_disk_offset(axis: torch.Tensor, radius, u1: torch.Tensor,
                       u2: torch.Tensor) -> torch.Tensor:
    """Uniform offset on the disk of ``radius`` perpendicular to ``axis``
    (..., 3): jitters a light's position for soft shadows (radius 0 gives
    a zero offset)."""
    t, b = onb(axis)
    r = radius * torch.sqrt(u1)
    phi = 2.0 * np.pi * u2
    return t * (r * torch.cos(phi))[..., None] + b * (r * torch.sin(phi))[..., None]
