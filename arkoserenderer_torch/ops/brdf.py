"""Filament-style BRDF (port of arkoserenderer_tpu/ops/brdf.py: ``evaluate``
and ``sample_ggx_vndf``): GGX NDF, height-correlated Smith visibility,
Schlick Fresnel, Lambert diffuse and a Kelemen clearcoat lobe, and the
GGX visible-normal sampler of the path tracer's specular bounces.
Directions point away from the surface and are unit length."""

from __future__ import annotations

import math

import numpy as np
import torch

from arkoserenderer_torch.core.constants import device_constant
from arkoserenderer_torch.core.mathx import normalize, vdot

DIELECTRIC_F0 = 0.04
MIN_ROUGHNESS = 0.045


def d_ggx(n_dot_h, alpha):
    a2 = alpha * alpha
    f = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (math.pi * f * f + 1e-20)


def v_smith_ggx_correlated(n_dot_v, n_dot_l, alpha):
    a2 = alpha * alpha
    lv = n_dot_l * torch.sqrt((n_dot_v - n_dot_v * a2) * n_dot_v + a2)
    ll = n_dot_v * torch.sqrt((n_dot_l - n_dot_l * a2) * n_dot_l + a2)
    return 0.5 / (lv + ll + 1e-20)


def f_schlick(u, f0, f90=1.0):
    return f0 + (f90 - f0) * (1.0 - u) ** 5


def v_kelemen(l_dot_h):
    return 0.25 / torch.clamp(l_dot_h * l_dot_h, min=1e-6)


def base_f0(base_color, metallic, reflectance=DIELECTRIC_F0):
    return reflectance * (1.0 - metallic) + base_color * metallic


def evaluate(l, v, n, base_color, roughness, metallic,
             clearcoat=None, clearcoat_roughness=None):
    """f(l, v) * <n.l> per pixel: (N,3) directions and colours, (N,1)
    scalars -> (N,3) radiance per unit illuminance."""
    h = normalize(l + v)
    n_dot_v = torch.abs(vdot(n, v)) + 1e-5
    n_dot_l = torch.clamp(vdot(n, l), 0.0, 1.0)
    n_dot_h = torch.clamp(vdot(n, h), 0.0, 1.0)
    l_dot_h = torch.clamp(vdot(l, h), 0.0, 1.0)

    rough = torch.clamp(roughness, min=MIN_ROUGHNESS)
    alpha = rough * rough

    f0 = base_f0(base_color, metallic)
    f = f_schlick(l_dot_h, f0)
    d = d_ggx(n_dot_h, alpha)
    vis = v_smith_ggx_correlated(n_dot_v, n_dot_l, alpha)
    specular = d * vis * f
    diffuse = base_color * (1.0 - metallic) / math.pi
    fr = diffuse + specular

    if clearcoat is not None:
        cc_rough = torch.clamp(clearcoat_roughness, 0.1, 1.0)
        cc_alpha = cc_rough * cc_rough
        dc = d_ggx(n_dot_h, cc_alpha)
        vc = v_kelemen(l_dot_h)
        fc = f_schlick(l_dot_h, DIELECTRIC_F0) * clearcoat
        fr = fr * (1.0 - fc) + dc * vc * fc
    return fr * n_dot_l


def env_fresnel_roughness(n_dot_v, f0, roughness):
    """Fresnel with a roughness-aware grazing response, for ambient and
    reflection terms."""
    f90 = torch.maximum(1.0 - roughness, f0)
    return f0 + (f90 - f0) * (1.0 - n_dot_v) ** 5


def sample_ggx_vndf(v_ts: torch.Tensor, alpha: torch.Tensor, u1: torch.Tensor,
                    u2: torch.Tensor) -> torch.Tensor:
    """A half vector from the GGX distribution of visible normals (Heitz
    2018): ``v_ts`` (N, 3) view direction in tangent space (+Z the normal),
    ``alpha`` (N,) -> (N, 3) half vector in tangent space."""
    a = alpha
    vh = normalize(torch.stack([a * v_ts[:, 0], a * v_ts[:, 1], v_ts[:, 2]], dim=-1))
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where((lensq > 1e-12)[:, None],
                     torch.stack([-vh[:, 1] * inv, vh[:, 0] * inv, torch.zeros_like(inv)], dim=-1),
                     device_constant("brdf.x_axis", lambda: np.array([1.0, 0.0, 0.0], np.float32),
                                     vh.device).expand_as(vh))
    t2 = torch.cross(vh, t1, dim=-1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[:, None] * t1 + p2[:, None] * t2 + p3[:, None] * vh
    ne = torch.stack([a * nh[:, 0], a * nh[:, 1], torch.clamp(nh[:, 2], min=0.0)], dim=-1)
    return normalize(ne)
