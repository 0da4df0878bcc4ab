"""Equirectangular environment map: bilinear sampling and SH-2 irradiance
(port of arkoserenderer_tpu/ops/envmap.py)."""

from __future__ import annotations

import math

import torch


def direction_to_equirect_uv(d: torch.Tensor) -> torch.Tensor:
    """(N,3) unit directions -> (N,2) uv; v = 0 at +Y, u wraps at -Z."""
    u = torch.atan2(d[:, 0], -d[:, 2]) / (2.0 * math.pi) + 0.5
    v = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], dim=-1)


def sample_equirect(env: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W, 3) equirect map along (N, 3) directions;
    U wraps, V clamps."""
    h, w = env.shape[0], env.shape[1]
    uv = direction_to_equirect_uv(d)
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x0w = torch.remainder(x0i, w)
    x1w = torch.remainder(x0i + 1, w)
    y0c = torch.clamp(y0i, 0, h - 1)
    y1c = torch.clamp(y0i + 1, 0, h - 1)
    flat = env.reshape(-1, env.shape[-1])
    top = flat[y0c * w + x0w] * (1 - fx) + flat[y0c * w + x1w] * fx
    bot = flat[y1c * w + x0w] * (1 - fx) + flat[y1c * w + x1w] * fx
    return top * (1 - fy) + bot * fy


def average_radiance(env: torch.Tensor) -> torch.Tensor:
    """(3,) solid-angle-weighted mean radiance of an (H, W, 3) equirect map."""
    h = env.shape[0]
    theta = (torch.arange(h, dtype=torch.float32, device=env.device) + 0.5) / h * math.pi
    weights = torch.sin(theta)[:, None, None]
    return torch.sum(env * weights, dim=(0, 1)) / (torch.sum(weights) * env.shape[1])


_C0, _C1, _C2, _C3, _C4 = 0.282095, 0.488603, 1.092548, 0.315392, 0.546274


def sh2_project(env: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) equirect radiance -> (9, 3) SH-2 irradiance coefficients
    (the convolution factors pi, 2pi/3, pi/4 folded in)."""
    h, w = env.shape[0], env.shape[1]
    f32 = dict(dtype=torch.float32, device=env.device)
    theta = (torch.arange(h, **f32) + 0.5) / h * math.pi
    phi = ((torch.arange(w, **f32) + 0.5) / w - 0.5) * 2.0 * math.pi
    st = torch.sin(theta)[:, None]
    ct = torch.cos(theta)[:, None]
    x = st * torch.sin(phi)[None, :]
    y = ct * torch.ones_like(phi)[None, :]
    z = -st * torch.cos(phi)[None, :]
    d_omega = st.expand(h, w) * ((math.pi / h) * (2.0 * math.pi / w))
    basis = torch.stack([
        torch.full_like(x, _C0),
        _C1 * y, _C1 * z, _C1 * x,
        _C2 * x * y, _C2 * y * z,
        _C3 * (3.0 * z * z - 1.0),
        _C2 * x * z, _C4 * (x * x - y * y),
    ])
    coeffs = torch.einsum("bhw,hwc->bc", basis * d_omega[None], env)
    a = torch.tensor([math.pi] + [2.0 * math.pi / 3.0] * 3 + [math.pi / 4.0] * 5, **f32)
    return coeffs * a[:, None]


def sh2_irradiance(coeffs: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(9, 3) coefficients + (N, 3) unit normals -> (N, 3) irradiance."""
    x, y, z = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    bs = [
        torch.full_like(x, _C0),
        _C1 * y, _C1 * z, _C1 * x,
        _C2 * x * y, _C2 * y * z,
        _C3 * (3.0 * z * z - 1.0),
        _C2 * x * z, _C4 * (x * x - y * y),
    ]
    out = bs[0] * coeffs[0][None, :]
    for i in range(1, 9):
        out = out + bs[i] * coeffs[i][None, :]
    return torch.clamp(out, min=0.0)


def ambient_of_normal(env: torch.Tensor, n: torch.Tensor, brightness=1.0) -> torch.Tensor:
    """(N, 3) diffuse ambient (irradiance / pi) per normal."""
    return sh2_irradiance(sh2_project(env), n) * (brightness / math.pi)
