"""Wrapper of the hand-written packed deferred-shading kernel
(csrc/packed_shading.cu): ``ops.packed_shading.shade_packed`` for CUDA
tensors, in one launch.

``shade_packed_cuda`` takes ``shade_packed_plain``'s arguments and gives
its G-buffer. It checks every tensor the kernel reads (dtype, shape and
contiguity, then the device), allocates the outputs with ``torch.empty``
and launches on the current stream without synchronising;
``shade_packed_cuda.launches`` counts its launches. It takes every branch
of the plain version (the four record layouts, every texture quality and
none, each sun source, shadowed and unshadowed spot and point lights, the
mip bias); what it cannot take raises ValueError, and nothing falls back
to the plain version.

The kernel reads each per-frame value (the camera, the sun, the lights,
the frame index of the stochastic filters) through a device pointer, since
a captured frame replays its launch; only what a pipeline fixes at
construction goes by value (``ShadeArgs``). The sRGB decode table is made
on the device, once a device, by ``ops.mattex``'s own decode, so its values
are the plain version's bit for bit; like a device constant it is made at
the first call, which comes before any capture (the capture's warm-up
frame is one).
"""

from __future__ import annotations

import ctypes

import torch

from arkoserenderer_torch.core.constants import device_constant
from arkoserenderer_torch.core.halton import fibonacci_disc
from arkoserenderer_torch.ops import mattex
from arkoserenderer_torch.ops.noise import blue_noise_mask
from arkoserenderer_torch.ops.packed_shading import RecLayout, layout_of
from arkoserenderer_torch.ops.shading import GBuffer

# Texture qualities (csrc/packed_shading.cu ``Quality``); Q_NONE: no texture.
Q_NONE, Q_TRILINEAR, Q_BILINEAR, Q_ANISO, Q_STOCHASTIC, Q_STOCHASTIC1 = range(6)
_QUALITIES = {"trilinear": Q_TRILINEAR, "auto": Q_TRILINEAR, "sorted": Q_TRILINEAR,
              "bilinear": Q_BILINEAR, "stochastic": Q_STOCHASTIC,
              "stochastic1": Q_STOCHASTIC1}
# The sun's visibility (``SunMode``): none, the ray-traced mask, the VSM's
# bilinear or jittered tap.
SUN_NONE, SUN_MASK, SUN_VSM, SUN_VSM_STOCHASTIC = range(4)
PCF_TAPS, PCF_RADIUS_TEXELS = 8, 1.5  # ops.shadow.sample_shadow_pcf's defaults
MAX_SPOTS = 31  # the PCF flags are bits of an int


class ShadeArgs(ctypes.Structure):
    """csrc/packed_shading.cu's ``Args``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "vis", "px", "py", "rec", "tex_rows", "srgb_lut", "noise_mask", "frame_index",
        "cam_pos", "exposure", "vp_cur", "vp_prev",
        "sun_dir", "sun_color", "sun_valid", "sun_vp", "shadow_mask", "moments",
        "spot_pos", "spot_dir", "spot_color", "spot_cone", "spot_ies", "spot_vp",
        "local_maps", "rt_spot", "point_pos", "point_color", "rt_point",
        "color", "normal", "velocity", "base_color", "material", "coverage",
    )] + [(name, ctypes.c_int) for name in (
        "n", "grid_w", "rows", "n_rec", "rec_size", "has_prev", "has_tan", "tex_last",
        "quality", "aniso_taps", "sun_mode", "vsm_size", "n_spots", "n_points", "spot_pcf",
        "local_size", "frame_value",
    )] + [(name, ctypes.c_float) for name in ("frame_w", "frame_h", "mip_bias")] + [
        ("pcf_taps", ctypes.c_float * (2 * PCF_TAPS)),
    ]


def quality_code(any_tex: bool, texture_quality: str) -> tuple[int, int]:
    """(the kernel's quality, anisotropic taps) as ``ops.mattex.sample_packed``
    reads ``quality``; Q_NONE without textures."""
    if not any_tex:
        return Q_NONE, 0
    if texture_quality.startswith("aniso"):
        return Q_ANISO, max(int(texture_quality[5:] or "4"), 1)
    if texture_quality not in _QUALITIES:
        raise ValueError(f"unknown texture quality {texture_quality!r}")
    return _QUALITIES[texture_quality], 0


def sun_mode(shadow_mask, shadow_moments, shadow_filter: str) -> int:
    """The sun's visibility as the plain version picks it: the ray-traced
    mask wins, then the VSM (jittered under ``shadow_filter="stochastic"``),
    else lit."""
    if shadow_mask is not None:
        return SUN_MASK
    if shadow_moments is not None:
        return SUN_VSM_STOCHASTIC if shadow_filter == "stochastic" else SUN_VSM
    return SUN_NONE


def spot_pcf_bits(n_spots: int, rt_spot_masks, local_shadow_maps, spot_shadow_flags) -> int:
    """Bit i set where spot i takes PCF of its local map: no ray-traced
    masks, a map and a flag."""
    if rt_spot_masks is not None or local_shadow_maps is None or spot_shadow_flags is None:
        return 0
    return sum(1 << i for i in range(min(n_spots, len(spot_shadow_flags)))
               if spot_shadow_flags[i])


def pcf_disc(size: int) -> list[float]:
    """The PCF disc's (du, dv) offsets for a ``size``^2 map, as
    ``sample_shadow_pcf`` forms them."""
    return [float(v) for v in (fibonacci_disc(PCF_TAPS) * (PCF_RADIUS_TEXELS / size)).ravel()]


def _check(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(name: str, t: torch.Tensor, dtype, min_rows: int, shape) -> None:
    """``t`` of shape (R, *shape) with R >= min_rows."""
    _check(name, t, dtype)
    if t.dim() != 1 + len(shape) or tuple(t.shape[1:]) != tuple(shape) or t.shape[0] < min_rows:
        raise ValueError(f"{name} must have shape (>= {min_rows}, {', '.join(map(str, shape))}), "
                         f"got {tuple(t.shape)}")


_SRGB: dict = {}


def srgb_table(device) -> torch.Tensor:
    """(256,) float32: ``ops.mattex``'s sRGB decode of each byte / 255, made
    on ``device`` by that decode, once a device."""
    device = torch.device(device)
    t = _SRGB.get(device)
    if t is None:
        b = torch.arange(256, dtype=torch.int32, device=device).to(torch.float32) * (1.0 / 255.0)
        t = _SRGB[device] = mattex._srgb_to_linear(b).contiguous()
    return t


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def shade_packed_cuda(
    scene,
    cam,
    vis_flat: torch.Tensor,
    depth_flat: torch.Tensor,
    records: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    width: int,
    height: int,
    shadow_moments: torch.Tensor | None = None,
    sun_shadow_vp: torch.Tensor | None = None,
    shadow_mask: torch.Tensor | None = None,
    local_shadow_maps: torch.Tensor | None = None,
    spot_shadow_flags: tuple | None = None,
    rt_spot_masks: torch.Tensor | None = None,
    rt_point_masks: torch.Tensor | None = None,
    n_spots: int = 0,
    n_points: int = 0,
    any_tex: bool = True,
    mip_bias: float = 0.0,
    texture_quality: str = "trilinear",
    shadow_filter: str = "bilinear",
    frame_index=0,
    *,
    layout: RecLayout,
) -> GBuffer:
    """The kernel behind ``ops.packed_shading.shade_packed`` for CUDA
    tensors; ``shade_packed_plain``'s contract. The pixels are
    ``vis_flat.numel() / width`` rows of ``width``."""
    f32, i32 = torch.float32, torch.int32
    quality, aniso_taps = quality_code(any_tex, texture_quality)
    mode = sun_mode(shadow_mask, shadow_moments, shadow_filter)
    if not 0 <= n_spots <= MAX_SPOTS or n_points < 0:
        raise ValueError(f"the kernel takes 0-{MAX_SPOTS} spots and >= 0 points, got "
                         f"{n_spots} and {n_points}")
    if layout != layout_of(layout.has_prev, layout.has_tan):
        raise ValueError(f"the kernel takes the layouts of packed_shading.layout_of, got {layout}")
    _check("vis_flat", vis_flat, i32)
    n = vis_flat.numel()
    if vis_flat.dim() != 1 or width <= 0 or n % width:
        raise ValueError(f"vis_flat must be (rows * {width},), got {tuple(vis_flat.shape)}")
    _check("px", px, f32, (n,))
    _check("py", py, f32, (n,))
    _check_rows("records", records, f32, 1, (layout.rec_size,))
    lights = scene.lights
    _check("cam.position", cam.position, f32, (3,))
    _check("cam.exposure", cam.exposure, f32, ())
    _check("lights.sun_direction", lights.sun_direction, f32, (3,))
    _check("lights.sun_color", lights.sun_color, f32, (3,))
    _check("lights.sun_valid", lights.sun_valid, torch.bool, ())
    tex_rows = scene.mat_tex.rows
    if quality != Q_NONE:
        _check_rows("mat_tex.rows", tex_rows, i32, 1, (3,))
    vsm_size = 0
    if mode == SUN_MASK:
        _check("shadow_mask", shadow_mask, f32, (n,))
    elif mode != SUN_NONE:
        _check("shadow_moments", shadow_moments, f32)
        vsm_size = shadow_moments.shape[0]
        if tuple(shadow_moments.shape) != (vsm_size, vsm_size, 2) or vsm_size == 0:
            raise ValueError(f"shadow_moments must be (S, S, 2), got {tuple(shadow_moments.shape)}")
        if sun_shadow_vp is None:
            raise ValueError("shadow_moments needs sun_shadow_vp")
        _check("sun_shadow_vp", sun_shadow_vp, f32, (4, 4))
    pcf = spot_pcf_bits(n_spots, rt_spot_masks, local_shadow_maps, spot_shadow_flags)
    local_size = 0
    if n_spots:
        for name, shape in (("spot_pos", (3,)), ("spot_dir", (3,)), ("spot_color", (3,)),
                            ("spot_cone", (2,)), ("spot_ies", (256,))):
            _check_rows(f"lights.{name}", getattr(lights, name), f32, n_spots, shape)
        if rt_spot_masks is not None:
            _check_rows("rt_spot_masks", rt_spot_masks, f32, n_spots, (n,))
        if pcf:
            _check_rows("lights.spot_view_proj", lights.spot_view_proj, f32, n_spots, (4, 4))
            local_size = local_shadow_maps.shape[-1]
            _check_rows("local_shadow_maps", local_shadow_maps, f32, pcf.bit_length(),
                        (local_size, local_size))
    if n_points:
        for name in ("point_pos", "point_color"):
            _check_rows(f"lights.{name}", getattr(lights, name), f32, n_points, (3,))
        if rt_point_masks is not None:
            _check_rows("rt_point_masks", rt_point_masks, f32, n_points, (n,))
    frame_value = 0
    if isinstance(frame_index, torch.Tensor):
        if frame_index.dim() != 0 or frame_index.dtype.is_floating_point:
            raise ValueError(f"frame_index must be a 0-d integer tensor, got {frame_index!r}")
    elif not -2**31 <= int(frame_index) < 2**31:
        raise ValueError(f"frame_index {frame_index} is out of int32 range")
    else:
        frame_value = int(frame_index)

    dev = vis_flat.device
    if dev.type != "cuda":
        raise ValueError(f"vis_flat must be a CUDA tensor, got {dev}")
    inputs = [px, py, records, cam.position, cam.exposure, lights.sun_direction,
              lights.sun_color, lights.sun_valid, shadow_mask, shadow_moments, sun_shadow_vp,
              rt_spot_masks, rt_point_masks, local_shadow_maps]
    inputs += [tex_rows] if quality != Q_NONE else []
    inputs += [lights.spot_pos, lights.spot_dir, lights.spot_color, lights.spot_cone,
               lights.spot_ies, lights.spot_view_proj] if n_spots else []
    inputs += [lights.point_pos, lights.point_color] if n_points else []
    if any(t is not None and t.device != dev for t in inputs):
        raise ValueError("all shading inputs must be on one device")
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned (the kernel reads them as float4)")
    if isinstance(frame_index, torch.Tensor):
        frame_index = frame_index.to(device=dev, dtype=i32)  # a device op: capturable

    from arkoserenderer_torch.ops.raster_cuda import build_kernels

    lib = build_kernels()
    if lib.packed_shading_args_size() != ctypes.sizeof(ShadeArgs):
        raise RuntimeError("ShadeArgs does not match csrc/packed_shading.cu's Args")
    color = torch.empty((n, 3), dtype=f32, device=dev)
    normal = torch.empty((n, 3), dtype=f32, device=dev)
    velocity = torch.empty((n, 2), dtype=f32, device=dev)
    base_color = torch.empty((n, 3), dtype=f32, device=dev)
    material = torch.empty((n, 4), dtype=f32, device=dev)
    coverage = torch.empty((n,), dtype=torch.bool, device=dev)
    # Device-side products the kernel reads; formed on the stream, so
    # a captured frame forms them at every replay.
    vp_cur = cam.unjittered_view_proj.contiguous()
    vp_prev = cam.prev_view_proj.contiguous()
    a = ShadeArgs(
        vis=vis_flat.data_ptr(), px=px.data_ptr(), py=py.data_ptr(), rec=records.data_ptr(),
        tex_rows=tex_rows.data_ptr() if quality != Q_NONE else None,
        srgb_lut=srgb_table(dev).data_ptr(),
        noise_mask=device_constant("blue noise mask", blue_noise_mask, dev).data_ptr(),
        frame_index=_ptr(frame_index if isinstance(frame_index, torch.Tensor) else None),
        cam_pos=cam.position.data_ptr(), exposure=cam.exposure.data_ptr(),
        vp_cur=vp_cur.data_ptr(), vp_prev=vp_prev.data_ptr(),
        sun_dir=lights.sun_direction.data_ptr(), sun_color=lights.sun_color.data_ptr(),
        sun_valid=lights.sun_valid.data_ptr(),
        sun_vp=_ptr(sun_shadow_vp), shadow_mask=_ptr(shadow_mask), moments=_ptr(shadow_moments),
        spot_pos=lights.spot_pos.data_ptr(), spot_dir=lights.spot_dir.data_ptr(),
        spot_color=lights.spot_color.data_ptr(), spot_cone=lights.spot_cone.data_ptr(),
        spot_ies=lights.spot_ies.data_ptr(), spot_vp=lights.spot_view_proj.data_ptr(),
        local_maps=_ptr(local_shadow_maps), rt_spot=_ptr(rt_spot_masks),
        point_pos=lights.point_pos.data_ptr(), point_color=lights.point_color.data_ptr(),
        rt_point=_ptr(rt_point_masks),
        color=color.data_ptr(), normal=normal.data_ptr(), velocity=velocity.data_ptr(),
        base_color=base_color.data_ptr(), material=material.data_ptr(),
        coverage=coverage.data_ptr(),
        n=n, grid_w=width, rows=n // width, n_rec=records.shape[0], rec_size=layout.rec_size,
        has_prev=int(layout.has_prev), has_tan=int(layout.has_tan),
        tex_last=tex_rows.shape[0] - 1 if quality != Q_NONE else 0,
        quality=quality, aniso_taps=aniso_taps, sun_mode=mode, vsm_size=vsm_size,
        n_spots=n_spots, n_points=n_points, spot_pcf=pcf, local_size=local_size,
        frame_value=frame_value, frame_w=float(width), frame_h=float(height),
        mip_bias=float(mip_bias),
    )
    if pcf:
        a.pcf_taps[:] = pcf_disc(local_size)
    err = lib.packed_shading_launch(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err == 1:  # cudaErrorInvalidValue: a size or layout the kernel does not take
        raise ValueError(f"packed_shading_launch refused {n} pixels of width {width}, "
                         f"layout {layout}")
    if err != 0:
        raise RuntimeError(f"packed_shading_launch failed: CUDA error {err}")
    shade_packed_cuda.launches += 1
    return GBuffer(color=color, normal=normal, velocity=velocity, base_color=base_color,
                   material=material, depth=depth_flat, valid=coverage)


shade_packed_cuda.launches = 0
