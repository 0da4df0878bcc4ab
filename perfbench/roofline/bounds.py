"""Least bytes of the two hand-written kernels' work in one frame.

Raster (``raster_tiles_kernel``): each raster's image written once: the
visibility id (int32) and the reverse-Z depth (float32) of every pixel, or
the depth alone for a depth-only map. The triangles' reads are left out:
which triangles a raster needs depends on culling, which the program does.

Traversal (``bvh_trace_kernel``): each ray read once (origin and direction,
six float32), each hit written once (t, triangle, u, v: four 4-byte values),
and the scene's triangles read once a trace (three float32 corners each).
A frame's traces follow from the configuration: a ray a pixel for the
screen traces, rays a probe times probes a frame for DDGI's.

Both are bandwidth bounds: neither kernel's arithmetic comes near the
float32 peak at these sizes. The least time is bytes over the peak
bandwidth."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
VIS_BYTES, DEPTH_BYTES = 4, 4
RAY_BYTES, HIT_BYTES, TRI_BYTES = 24, 16, 36


def raster_bytes(width: int, height: int, depth_only: bool) -> int:
    return width * height * (DEPTH_BYTES if depth_only else VIS_BYTES + DEPTH_BYTES)


def trace_bytes(rays: int, triangles: int) -> int:
    return rays * (RAY_BYTES + HIT_BYTES) + triangles * TRI_BYTES


def frame_raster_bytes(config: dict) -> int:
    """The rasters of one frame (``rasters_per_frame``: the camera's at the
    frame size, the sun's at ``shadow_map_size`` squared)."""
    total = 0
    for r in config.get("rasters_per_frame", []):
        if r["what"] == "camera":
            w, h = config["width"], config["height"]
        elif r["what"] == "sun":
            w = h = config["shadow_map_size"]
        else:
            raise ValueError(f"unknown raster {r['what']!r}")
        total += raster_bytes(int(w), int(h), bool(r["depth_only"]))
    return total


def frame_trace_bytes(config: dict) -> int:
    """The traces of one frame (``traces_per_frame``: "pixels" traces a ray
    a pixel, "ddgi" rays a probe times probes a frame)."""
    total = 0
    for kind in config.get("traces_per_frame", {}).values():
        if kind == "pixels":
            rays = int(config["width"]) * int(config["height"])
        elif kind == "ddgi":
            d = config["ddgi"]
            rays = int(d["rays_per_probe"]) * int(d["probes_per_frame"])
        else:
            raise ValueError(f"unknown trace kind {kind!r}")
        total += trace_bytes(rays, int(config.get("scene_triangles", 0)))
    return total


def least_seconds(nbytes: int) -> float:
    return nbytes / PEAKS["hbm_bytes_per_s"]
