"""Measurements of the packed deferred-shading kernel (csrc/packed_shading.cu)
on the card.

Helpers used by chip_smoke.py and the tests: the shading calls of one frame
captured as the frame makes them (``capture_shading_calls``), the kernel's
G-buffer held against the plain version's (``agreement``, under the
tolerances of ``within_tolerance``), the kernel's bound (``bound_ms``: 65
bytes a pixel, the visibility id read and the G-buffer written once, over
the peak bandwidth) and three timings (``measure``): the kernel's device
time (a CUDA graph of wrapper calls, so no host cost enters it), the
wrapper's (CUDA events around back-to-back calls, as the frame calls it)
and the plain version's.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.ops import packed_shading, packed_shading_cuda
from arkoserenderer_torch.rendering.pipeline import eager_frames
from arkoserenderer_torch.tools.raster_bench import HBM_BYTES_PER_S, events_ms, graph_ms

# Compulsory bytes a pixel: the visibility id read (4) and the G-buffer
# written once: SceneColor 12, SceneNormal 12, SceneVelocity 8,
# SceneBaseColor 12, SceneMaterial 16, SceneCoverage 1.
PIXEL_BYTES = 4 + 12 + 12 + 8 + 12 + 16 + 1
OUTPUTS = ("color", "normal", "velocity", "base_color", "material")
# The kernel against the plain version: each float output's mean |difference|
# within MEAN_REL of its mean |plain| (the kernel performs the plain
# operations in their order, so only a transcendental's rounding or a floor
# or round that flips at a boundary can differ), and fewer than OFF_SHARE of
# the pixels off by more than OFF_REL relative (plus OFF_ABS for lanes near
# 0): the pixels whose mip level or wrapped texel flips.
MEAN_REL, OFF_REL, OFF_ABS, OFF_SHARE = 1e-5, 1e-3, 1e-6, 1e-3
WRAPPER_CALLS, PLAIN_CALLS = 20, 3


def capture_shading_calls(frame) -> tuple[list, object]:
    """Call ``frame()`` and return (the arguments of every packed-shading
    launch it makes, in order, as (args, kwargs); what ``frame()``
    returned). The launches count as usual. Frames run eagerly within it
    (``eager_frames``: a replay calls no wrapper)."""
    calls = []
    kernel = packed_shading_cuda.shade_packed_cuda

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)

    record.launches = kernel.launches  # the kernel counts through the module's name
    packed_shading_cuda.shade_packed_cuda = record
    try:
        with eager_frames():
            out = frame()
    finally:
        packed_shading_cuda.shade_packed_cuda = kernel
        kernel.launches = record.launches
    torch.cuda.synchronize()
    return calls, out


def agreement(ours: packed_shading.GBuffer, plain: packed_shading.GBuffer) -> dict:
    """The kernel's G-buffer against the plain version's: coverage equal,
    and per float output the share of pixels bit for bit, the mean
    |difference| over the mean |plain| and the share of pixels off (see
    OFF_REL)."""
    out = {"coverage_equal": bool(torch.equal(ours.valid, plain.valid)),
           "pixels": int(plain.valid.numel()), "covered": int(plain.valid.sum())}
    for name in OUTPUTS:
        a, b = getattr(ours, name), getattr(plain, name)
        diff = (a - b).abs()
        scale = float(b.abs().mean())
        off = (diff > OFF_REL * b.abs() + OFF_ABS).any(dim=-1)
        out[name] = {
            "exact": float((a == b).all(dim=-1).float().mean()),
            "mean_rel": float(diff.mean()) / scale if scale > 0 else float(diff.mean()),
            "off": float(off.float().mean()),
            "finite": bool(torch.isfinite(a).all()),
        }
    return out


def within_tolerance(agree: dict) -> bool:
    return agree["coverage_equal"] and all(
        agree[n]["finite"] and agree[n]["mean_rel"] <= MEAN_REL and agree[n]["off"] < OFF_SHARE
        for n in OUTPUTS)


def bound_ms(pixels: int) -> float:
    """The least time of one shading of ``pixels`` pixels: their compulsory
    bytes over the peak bandwidth."""
    return pixels * PIXEL_BYTES / HBM_BYTES_PER_S * 1e3


def measure(call: tuple) -> dict:
    """One captured call (``capture_shading_calls``) on the card: the kernel
    against the plain version (``agreement``) and their times, the bound
    and the kernel's share of it."""
    args, kwargs = call
    launches = packed_shading_cuda.shade_packed_cuda.launches  # restored: no frame's launches
    ours = packed_shading_cuda.shade_packed_cuda(*args, **kwargs)
    plain = packed_shading.shade_packed_plain(*args, **kwargs)
    agree = agreement(ours, plain)
    del ours, plain
    device_ms = graph_ms(lambda: packed_shading_cuda.shade_packed_cuda(*args, **kwargs))
    wrapper_ms = events_ms(lambda: packed_shading_cuda.shade_packed_cuda(*args, **kwargs),
                           WRAPPER_CALLS)
    packed_shading_cuda.shade_packed_cuda.launches = launches
    plain_ms = events_ms(lambda: packed_shading.shade_packed_plain(*args, **kwargs),
                         PLAIN_CALLS)
    pixels = args[2].numel()
    bound = bound_ms(pixels)
    return {"agreement": agree, "ok": within_tolerance(agree), "pixels": pixels,
            "device_ms": device_ms, "ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "share": bound / device_ms, "library_ms": None}
