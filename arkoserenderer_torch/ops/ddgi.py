"""DDGI: the dynamic diffuse global-illumination probe grid (port of
arkoserenderer_tpu/ops/ddgi.py).

A world-space grid of probes keeps two octahedral atlases: irradiance
(8x8 texels of pre-exposed radiance a probe) and visibility (16x16 texels
of the mean and mean square of the ray distance). Each frame updates
``probes_per_frame`` probes round-robin: their rays, the Fibonacci set
under a per-frame random rotation, go through the scene's BVH
(``ops/bvh.trace_rays``, the traversal kernel on the card); the hits are
shaded with the sun and the local lights (each behind an any-hit
occlusion ray) plus last frame's DDGI at the hit; the texel estimates are
cosine-weighted sums over the rays (matrix products) blended into the
atlases with hysteresis; probes that see mostly back faces move out of
the geometry. Sampling blends the 8 surrounding probes trilinearly, with
a normal-facing weight and a Chebyshev visibility test.

The traces carry the labels "ddgi probe" (closest-hit), "ddgi sun" and
"ddgi spot i" / "ddgi point i" (any-hit, one per casting light, i its
index). The rotation's four normals are JAX's (``core/prng``), drawn on
the host and uploaded each frame, as the grid's constants are each call.
Nothing in the update reads the device back.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.halton import fibonacci_sphere
from arkoserenderer_torch.core.prng import ddgi_rotation_normals
from arkoserenderer_torch.ops.bvh import trace_rays
from arkoserenderer_torch.ops.envmap import sample_equirect
from arkoserenderer_torch.ops.rt import PARK, surface_at_hits

IRRADIANCE_RES = 8
VISIBILITY_RES = 16


@dataclasses.dataclass(frozen=True)
class ProbeGridConfig:
    """Static grid layout, field for field the reference's."""

    dims: tuple[int, int, int] = (8, 4, 8)
    origin: tuple[float, float, float] = (-8.0, 0.0, -8.0)
    spacing: tuple[float, float, float] = (2.0, 2.0, 2.0)
    rays_per_probe: int = 128
    probes_per_frame: int = 64
    hysteresis: float = 0.94
    max_distance: float = 8.0      # visibility depth clamp
    normal_bias: float = 0.15
    energy_conservation: float = 0.95

    @property
    def num_probes(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @classmethod
    def fit_bounds(cls, center, radius, dims=(8, 4, 8), **kw):
        """The grid over a cube 1.05 times the bounding sphere's radius."""
        center = np.asarray(center, np.float32)
        half = radius * 1.05
        size = np.array([2 * half, 2 * half, 2 * half], np.float32)
        spacing = size / np.maximum(np.array(dims) - 1, 1)
        origin = center - size * 0.5
        return cls(dims=tuple(dims), origin=tuple(origin.tolist()),
                   spacing=tuple(spacing.tolist()),
                   max_distance=float(np.max(spacing) * 1.5), **kw)


class DDGIState(NamedTuple):
    irradiance: torch.Tensor  # (P, 8, 8, 3) pre-exposed radiance estimate
    visibility: torch.Tensor  # (P, 16, 16, 2) mean / mean^2 ray distance
    offsets: torch.Tensor     # (P, 3) probe relocation offsets (world units)


def init_state(cfg: ProbeGridConfig, device="cuda") -> DDGIState:
    """Zero irradiance and offsets; visibility (max_distance, its square)."""
    p = cfg.num_probes
    md = cfg.max_distance
    vis = np.full((p, VISIBILITY_RES, VISIBILITY_RES, 2), md, np.float32) * np.array(
        [1.0, md], np.float32)
    return DDGIState(
        irradiance=torch.zeros((p, IRRADIANCE_RES, IRRADIANCE_RES, 3), device=device),
        visibility=torch.from_numpy(vis).to(device),
        offsets=torch.zeros((p, 3), device=device),
    )


def probe_positions(cfg: ProbeGridConfig) -> np.ndarray:
    """(P, 3) grid positions; probe id = (x * gy + y) * gz + z."""
    gx, gy, gz = cfg.dims
    xs = np.arange(gx) * cfg.spacing[0] + cfg.origin[0]
    ys = np.arange(gy) * cfg.spacing[1] + cfg.origin[1]
    zs = np.arange(gz) * cfg.spacing[2] + cfg.origin[2]
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.float32)


# ---------------------------------------------------------------------------
# Octahedral mapping


def octahedral_decode(uv: torch.Tensor) -> torch.Tensor:
    """[0,1]^2 texel coordinates -> unit direction."""
    f = uv * 2.0 - 1.0
    z = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-z, 0.0, 1.0)
    x = f[..., 0] + torch.where(f[..., 0] >= 0.0, -t, t)
    y = f[..., 1] + torch.where(f[..., 1] >= 0.0, -t, t)
    return mx.normalize(torch.stack([x, y, z], dim=-1))


def octahedral_encode(d: torch.Tensor) -> torch.Tensor:
    """Unit direction -> [0,1]^2 (NaN for the zero vector)."""
    n = d / torch.sum(torch.abs(d), dim=-1, keepdim=True)
    xy = n[..., :2]
    wrap = (1.0 - torch.abs(xy.flip(-1))) * torch.where(xy >= 0.0, 1.0, -1.0)
    xy = torch.where(n[..., 2:3] < 0.0, wrap, xy)
    return xy * 0.5 + 0.5


def _texel_dirs(res: int) -> np.ndarray:
    """(res*res, 3) directions at the octahedral texel centres."""
    uv = (np.stack(np.meshgrid(np.arange(res), np.arange(res), indexing="xy"), -1)
          .reshape(-1, 2).astype(np.float32) + 0.5) / res
    f = uv * 2.0 - 1.0
    z = 1.0 - np.abs(f[:, 0]) - np.abs(f[:, 1])
    t = np.clip(-z, 0.0, 1.0)
    x = f[:, 0] + np.where(f[:, 0] >= 0.0, -t, t)
    y = f[:, 1] + np.where(f[:, 1] >= 0.0, -t, t)
    d = np.stack([x, y, z], -1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# Probe update


class _GridConstants(NamedTuple):
    positions: torch.Tensor   # (P, 3) probe positions without offsets
    fib_dirs: torch.Tensor    # (R, 3) the unrotated ray set
    tex_dirs_i: torch.Tensor  # (64, 3) irradiance texel directions
    tex_dirs_v: torch.Tensor  # (256, 3) visibility texel directions
    origin: torch.Tensor      # (3,)
    spacing: torch.Tensor     # (3,)
    top: torch.Tensor         # (3,) dims - 1 - 1e-4: the sampling clamp


@functools.lru_cache(maxsize=32)
def _constants(cfg: ProbeGridConfig, device: torch.device) -> _GridConstants:
    """The grid's constant tensors on ``device``, made once for a grid and a
    device (a frame uploads none of them)."""
    return _GridConstants(*(torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in (
        probe_positions(cfg), fibonacci_sphere(cfg.rays_per_probe),
        _texel_dirs(IRRADIANCE_RES), _texel_dirs(VISIBILITY_RES), cfg.origin, cfg.spacing,
        np.array(cfg.dims, np.float32) - 1.0 - 1e-4)))


def update_probes(
    scene,                       # SceneArrays with a BVH
    state: DDGIState,
    cfg: ProbeGridConfig,
    frame_index,                 # drives the round-robin and the ray rotation
    exposure: torch.Tensor,
    prev_state: DDGIState | None = None,
    n_spots: int = 0,            # the local lights the raster frame sees
    n_points: int = 0,
    spot_casters: tuple = (),
    point_casters: tuple = (),
    rotation: torch.Tensor | None = None,
) -> DDGIState:
    """One frame's probe update; returns the new state. The bounce term
    samples ``prev_state`` (default ``state``). ``frame_index`` is a host
    int or a 0-d integer tensor (the round-robin is then formed on the
    device); ``rotation`` is the frame's four normals
    (``ddgi_rotation_normals(frame_index)``) on the device, or None to draw
    them on the host from an int ``frame_index`` and upload them."""
    dev = state.irradiance.device
    p = cfg.num_probes
    n_up = min(cfg.probes_per_frame, p)
    r = cfg.rays_per_probe
    prev = prev_state or state

    positions, fib_dirs, tex_dirs_i, tex_dirs_v, _, spacing, _ = _constants(cfg, dev)

    if isinstance(frame_index, torch.Tensor):
        base = (frame_index.to(torch.int64) * n_up) % p
    else:
        base = (int(frame_index) * n_up) % p
    probe_ids = (torch.arange(n_up, device=dev) + base) % p
    pos = positions[probe_ids] + state.offsets[probe_ids]

    # The per-frame random rotation of the Fibonacci ray set.
    q = rotation
    if q is None:
        q = torch.from_numpy(ddgi_rotation_normals(int(frame_index))).to(dev)
    q = q / torch.linalg.vector_norm(q)
    dirs = mx.quat_rotate(q[None, :], fib_dirs)                 # (R, 3)

    origins = pos.repeat_interleave(r, dim=0)                   # (n_up*R, 3)
    ray_dirs = dirs.repeat(n_up, 1)
    hit = trace_rays(scene.bvh, origins, ray_dirs, t_max=1e4, label="ddgi probe")

    # Shade the hits: diffuse only.
    world_pos, nrm, _, mat_id = surface_at_hits(scene, hit)
    facing_away = mx.vdot(nrm, -ray_dirs) < 0.0
    backface = hit.hit & facing_away[:, 0]
    nrm = nrm * torch.where(facing_away, -1.0, 1.0)
    albedo = scene.materials.base_color_factor[mat_id.long()][:, :3]

    lights = scene.lights
    sun_l = -lights.sun_direction
    hit_col = hit.hit[:, None]
    # Missed probe rays trace nothing more: their occlusion rays start
    # parked outside the scene and leave the BVH in one step.
    shadow_org = torch.where(hit_col, world_pos + nrm * 1e-2, PARK)
    shadow = trace_rays(scene.bvh, shadow_org, sun_l.expand_as(world_pos).contiguous(),
                        any_hit=True, t_max=1e4, label="ddgi sun")
    n_dot_l = torch.clamp(mx.vdot(nrm, sun_l[None, :], keepdims=False), 0.0, 1.0)
    direct = (albedo / math.pi * (lights.sun_color * exposure)[None, :]
              * (n_dot_l * (~shadow.hit))[:, None] * lights.sun_valid)
    for li in range(n_spots):
        to_l = lights.spot_pos[li][None, :] - world_pos
        dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
        dist_l = torch.sqrt(dist2)
        l_dir = to_l / dist_l
        cos_dir = -mx.vdot(l_dir, lights.spot_dir[li][None, :], keepdims=False)
        cone = lights.spot_cone[li]
        tt = torch.clamp((cos_dir - cone[1]) / torch.clamp(cone[0] - cone[1], min=1e-4), 0.0, 1.0)
        angle_idx = torch.clamp(
            (torch.acos(torch.clamp(cos_dir, -1.0, 1.0)) / math.pi * 255.0).to(torch.int64), 0, 255)
        falloff = tt * tt * lights.spot_ies[li][angle_idx] / dist2[:, 0]
        if li >= len(spot_casters) or spot_casters[li]:
            occ_l = trace_rays(scene.bvh, shadow_org, l_dir.contiguous(),
                               t_max=torch.clamp(dist_l[:, 0] - 6e-2, min=1e-3), any_hit=True,
                               label=f"ddgi spot {li}")
            falloff = falloff * (~occ_l.hit)
        nl = torch.clamp(mx.vdot(nrm, l_dir, keepdims=False), 0.0, 1.0)
        direct = direct + albedo / math.pi * (lights.spot_color[li][None, :] * exposure) * (
            nl * falloff)[:, None]
    for li in range(n_points):
        to_l = lights.point_pos[li][None, :] - world_pos
        dist2 = torch.clamp(mx.vdot(to_l, to_l), min=1e-6)
        dist_l = torch.sqrt(dist2)
        l_dir = to_l / dist_l
        vis_l = 1.0
        if li < len(point_casters) and point_casters[li]:
            occ_l = trace_rays(scene.bvh, shadow_org, l_dir.contiguous(),
                               t_max=torch.clamp(dist_l[:, 0] - 6e-2, min=1e-3), any_hit=True,
                               label=f"ddgi point {li}")
            vis_l = (~occ_l.hit).to(torch.float32)
        nl = torch.clamp(mx.vdot(nrm, l_dir, keepdims=False), 0.0, 1.0)
        direct = direct + albedo / math.pi * (lights.point_color[li][None, :] * exposure) * (
            nl * vis_l)[:, None] / dist2

    # Infinite bounces: last frame's DDGI at the hit point.
    bounce = sample_irradiance(prev, cfg, world_pos, nrm) * albedo / math.pi
    radiance = direct + bounce * cfg.energy_conservation
    env = sample_equirect(scene.env_map, ray_dirs) * scene.env_brightness * exposure
    radiance = torch.where(hit_col, radiance, env).reshape(n_up, r, 3)

    dist = torch.where(hit.hit, hit.t, cfg.max_distance)
    dist = torch.clamp(dist, 0.0, cfg.max_distance).reshape(n_up, r)

    # Irradiance: cosine-weighted sums as (texels x rays) matrix products.
    w_i = torch.clamp(tex_dirs_i @ dirs.T, min=0.0)                      # (64, R)
    irr_num = torch.einsum("tr,nrc->ntc", w_i, radiance)
    irr_den = torch.sum(w_i, dim=1)[None, :, None]
    irr_new = (irr_num / torch.clamp(irr_den, min=1e-4)).reshape(
        n_up, IRRADIANCE_RES, IRRADIANCE_RES, 3)

    # Visibility: mean and mean square distance, sharply weighted.
    w_v = torch.clamp(tex_dirs_v @ dirs.T, min=0.0) ** 50.0             # (256, R)
    v_den = torch.clamp(torch.sum(w_v, dim=1), min=1e-6)[None, :]
    mean = torch.einsum("tr,nr->nt", w_v, dist) / v_den
    mean2 = torch.einsum("tr,nr->nt", w_v, dist * dist) / v_den
    vis_new = torch.stack([mean, mean2], dim=-1).reshape(n_up, VISIBILITY_RES, VISIBILITY_RES, 2)

    # Hysteresis blend into the atlases; a cold atlas takes the estimate.
    h = cfg.hysteresis
    old_irr = state.irradiance[probe_ids]
    old_vis = state.visibility[probe_ids]
    alpha = torch.where(torch.all(old_irr == 0.0), 1.0, 1.0 - h)
    irr = state.irradiance.index_copy(0, probe_ids, old_irr + (irr_new - old_irr) * alpha)
    vis = state.visibility.index_copy(0, probe_ids, old_vis + (vis_new - old_vis) * alpha)

    # Relocation: a probe seeing many back faces sits inside geometry; push
    # it along its closest back-face ray to just past that surface, within
    # 0.45 of the grid spacing.
    bf = backface.reshape(n_up, r)
    bf_frac = bf.to(torch.float32).mean(dim=1)
    t_all = torch.where(bf, hit.t.reshape(n_up, r), cfg.max_distance)
    closest = torch.argmin(t_all, dim=1)          # the first of equal minima, as JAX's
    t_min = torch.gather(t_all, 1, closest[:, None])[:, 0]
    esc_dir = dirs[closest]
    delta = esc_dir * (t_min + 0.15 * float(np.min(cfg.spacing)))[:, None]
    old_off = state.offsets[probe_ids]
    new_off = torch.where((bf_frac > 0.25)[:, None], old_off + delta, old_off)
    new_off = torch.clamp(new_off, -0.45 * spacing, 0.45 * spacing)
    offsets = state.offsets.index_copy(0, probe_ids, new_off)
    return DDGIState(irradiance=irr, visibility=vis, offsets=offsets)


# ---------------------------------------------------------------------------
# Sampling


def _oct_wrap(xi: torch.Tensor, yi: torch.Tensor, res: int):
    """Octahedral seam wrap of tap indices one texel out of [0, res): a tap
    off an edge reflects across it and flips the other axis; a corner tap
    lands on the opposite corner."""
    out_l = xi < 0
    out_r = xi >= res
    yi = torch.where(out_l | out_r, res - 1 - yi, yi)
    xi = torch.where(out_l, -1 - xi, torch.where(out_r, 2 * res - 1 - xi, xi))
    out_b = yi < 0
    out_t = yi >= res
    xi = torch.where(out_b | out_t, res - 1 - xi, xi)
    yi = torch.where(out_b, -1 - yi, torch.where(out_t, 2 * res - 1 - yi, yi))
    return xi, yi


def _bilinear_taps(uv: torch.Tensor, res: int):
    """The four tap offsets inside a probe's tile (texel rows, (N,) each,
    in the order (0,0), (1,0), (0,1), (1,1)) and the weights fx, fy (N, 1)
    of a bilinear fetch at octahedral ``uv``. Indices of a NaN ``uv`` (a
    lane whose result is discarded) are clamped into the tile."""
    x = uv[:, 0] * res - 0.5
    y = uv[:, 1] * res - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(xi, yi):
        xw, yw = _oct_wrap(xi, yi, res)
        return torch.clamp(yw, 0, res - 1) * res + torch.clamp(xw, 0, res - 1)

    return (tap(x0i, y0i), tap(x0i + 1, y0i), tap(x0i, y0i + 1), tap(x0i + 1, y0i + 1)), fx, fy


def _gather_bilinear(flat: torch.Tensor, base: torch.Tensor, taps, fx, fy) -> torch.Tensor:
    """Blend the four texel rows of ``flat`` (P*res*res, C) at ``base`` +
    each tap offset. The rows are gathered at their own width (3 or 2
    floats): torch gathers 16-byte rows far slower."""
    c00, c10, c01, c11 = (flat[base + t] for t in taps)
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def _bilinear_atlas(atlas: torch.Tensor, probe: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(P, R, R, C) atlas, (N,) probe ids, (N, 2) octahedral uv -> (N, C),
    bilinear with the octahedral seam wrap across tile edges."""
    res = atlas.shape[1]
    taps, fx, fy = _bilinear_taps(uv, res)
    return _gather_bilinear(atlas.reshape(-1, atlas.shape[-1]), probe.long() * (res * res),
                            taps, fx, fy)


def sample_irradiance(state: DDGIState, cfg: ProbeGridConfig, world_pos: torch.Tensor,
                      normal: torch.Tensor) -> torch.Tensor:
    """(N, 3) irradiance at (N, 3) points with (N, 3) normals: the 8
    surrounding probes blended trilinearly, with normal-facing and
    Chebyshev visibility weights. Rows with a non-finite point or normal
    give garbage, never an out-of-range fetch."""
    dev = world_pos.device
    gx, gy, gz = cfg.dims
    const = _constants(cfg, dev)
    origin, spacing, top = const.origin, const.spacing, const.top
    biased = world_pos + normal * cfg.normal_bias

    g = (biased - origin) / spacing
    g = torch.minimum(torch.clamp(g, min=0.0), top)
    g0 = torch.floor(g).to(torch.int64)
    f = g - g0

    irr_taps = _bilinear_taps(octahedral_encode(normal), IRRADIANCE_RES)
    irr_flat = state.irradiance.reshape(-1, 3)
    vis_flat = state.visibility.reshape(-1, 2)
    total = torch.zeros((world_pos.shape[0], 3), device=dev)
    total_w = torch.zeros((world_pos.shape[0], 1), device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cx = torch.clamp(g0[:, 0] + dx, 0, gx - 1)
                cy = torch.clamp(g0[:, 1] + dy, 0, gy - 1)
                cz = torch.clamp(g0[:, 2] + dz, 0, gz - 1)
                probe = (cx * gy + cy) * gz + cz
                probe_pos = (origin + torch.stack([cx, cy, cz], -1).to(torch.float32) * spacing
                             + state.offsets[probe])
                to_probe = probe_pos - world_pos
                dist = torch.linalg.vector_norm(to_probe, dim=-1)
                dir_p = to_probe / torch.clamp(dist, min=1e-6)[:, None]

                tw = ((dx * f[:, 0] + (1 - dx) * (1 - f[:, 0]))
                      * (dy * f[:, 1] + (1 - dy) * (1 - f[:, 1]))
                      * (dz * f[:, 2] + (1 - dz) * (1 - f[:, 2])))
                # Back-face probe rejection (smooth).
                facing = torch.clamp(mx.vdot(dir_p, normal, keepdims=False) * 0.5 + 0.5,
                                     0.0, 1.0) ** 2 + 0.05
                # Chebyshev visibility from the probe's depth statistics.
                mv = _gather_bilinear(vis_flat, probe * (VISIBILITY_RES * VISIBILITY_RES),
                                      *_bilinear_taps(octahedral_encode(-dir_p), VISIBILITY_RES))
                mean, mean2 = mv[:, 0], mv[:, 1]
                var = torch.clamp(mean2 - mean * mean, min=1e-4)
                d = torch.clamp(dist - mean, min=0.0)
                cheb = var / (var + d * d)
                vis_w = torch.where(dist <= mean, 1.0, torch.clamp(cheb ** 3, 0.05, 1.0))

                w = (tw * facing * vis_w)[:, None]
                irr = _gather_bilinear(irr_flat, probe * (IRRADIANCE_RES * IRRADIANCE_RES),
                                       *irr_taps)
                total = total + irr * w
                total_w = total_w + w
    return total / torch.clamp(total_w, min=1e-4)
