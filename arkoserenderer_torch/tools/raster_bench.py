"""Measurements of the stage-4 raster kernel (csrc/raster_tiles.cu) on the card.

Helpers used by chip_smoke.py and the tests: the forward frame's camera and
sun raster inputs and a spot light's local-shadow raster inputs, the (tile, triangle) pairs a raster walks and its pixel
tests before and after exact tile rejection (``ops.raster.tile_rejects``),
the kernel's bound, and two timings: the wrapper's (CUDA events around
back-to-back ``rasterize_tiles_cuda`` calls, as the frame calls it) and the
kernel's device time (a CUDA graph of launches through the C entry point
into outputs made once, so no host cost enters it).

Run as a script, it compares this checkout's kernel with the one of another
checkout (a root that holds ``arkoserenderer_torch/``), in turns (other,
this, this, other per round), on the forward frame's camera raster
(1920x1080, tile 8x128) and sun raster (8192^2, depth-only), after checking
that the two agree bit for bit. Each side is timed both ways, the wrapper
through its own ``ops/raster_cuda.py``:

    python -m arkoserenderer_torch.tools.raster_bench --other OLD_CHECKOUT

Prints the card line and one JSON line. Needs a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.ops.packed_shading import build_vertex_world, record_layout_for
from arkoserenderer_torch.ops import raster_cuda
from arkoserenderer_torch.rendering.passes.geometry import (
    transform_vertices_clip,
    visible_triangles,
    world_to_clip,
)

# One H100 SXM (NVIDIA's data sheet): HBM rate and float32 rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations of one pixel test with factored edge functions: 3 subtracts and
# 3 multiplies for the barycentrics, 5 for the depth, 5 comparisons, 2
# selects, plus the column and row terms amortised over the tile (~2).
OPS_PER_TEST = 20
# The A/B's rounds (other, this, this, other each), launches in one CUDA
# graph, and back-to-back wrapper calls under CUDA events a raster.
ROUNDS = 3
GRAPH_LAUNCHES = 50
WRAPPER_CALLS = {"camera": 50, "sun": 10, "local": 50}
# The adversarial case: viewport and numpy seed.
ADVERSARIAL_SIZE, ADVERSARIAL_SEED = 64, 7


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


ADVERSARIAL_CFG = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512, max_tiles_per_tri=4,
                               max_global_tris=128)


def adversarial_case():
    """Clip-space vertices (V, 4) f32 and indices (T, 3) i32 built to stress
    the corner test and the tie order at ``ADVERSARIAL_CFG``'s tiles:
    vertices exactly on pixel centres and on tile borders, slivers,
    zero-area triangles, huge triangles clipped by the near plane (w_eps
    0.1), and duplicated coplanar triangles; one run of 150 copies makes
    two tiles' lists longer than a staging window. Screen-space vertices
    sit at w = 1, where the screen mapping is exact for power-of-two sizes.
    The viewport is ADVERSARIAL_SIZE square; made from ADVERSARIAL_SEED
    with numpy."""
    rng = np.random.default_rng(ADVERSARIAL_SEED)
    width = height = ADVERSARIAL_SIZE
    tw, th = ADVERSARIAL_CFG.tile_w, ADVERSARIAL_CFG.tile_h

    def screen(pts, z):
        pts = np.asarray(pts, np.float64)
        x = 2.0 * pts[:, 0] / width - 1.0
        y = 1.0 - 2.0 * pts[:, 1] / height
        return np.stack([x, y, z, np.ones_like(x)], -1)

    def centres(n):  # pixel centres, a few beyond the viewport
        return np.stack([rng.integers(-4, width + 4, n) + 0.5,
                         rng.integers(-4, height + 4, n) + 0.5], -1)

    def borders(n):
        return np.stack([rng.integers(0, width // tw + 1, n) * tw,
                         rng.integers(0, height // th + 1, n) * th], -1).astype(np.float64)

    def depth(n):
        return rng.uniform(0.05, 0.95, n)

    tris = [screen(centres(3), depth(3)) for _ in range(40)]
    for _ in range(40):
        tris.append(screen(np.where(rng.random((3, 1)) < 0.5, borders(3), centres(3)), depth(3)))
    for _ in range(20):  # slivers
        a, c = centres(2)
        tris.append(screen([a, a + rng.normal(size=2) * 1e-3, c], depth(3)))
    for _ in range(10):  # zero area: a repeated vertex, or three collinear points
        a, d = centres(1)[0], rng.integers(-8, 9, 2)
        tris.append(screen([a, a, a + d] if rng.random() < 0.5 else [a, a + d, a + 2 * d],
                           depth(3)))
    proj = mx.perspective_reverse_z(np.radians(70.0), width / height, 0.1, 100.0)
    for _ in range(4):  # one vertex behind the camera, which looks down -z
        v = rng.uniform(-60.0, 60.0, (3, 3))
        v[0, 2] = rng.uniform(0.5, 5.0)
        v[1:, 2] = rng.uniform(-60.0, -1.0, 2)
        tris.append(np.concatenate([v @ proj[:3, :3].T + proj[:3, 3],
                                    (v @ proj[3, :3] + proj[3, 3])[:, None]], -1))
    n_single = len(tris)
    tris += [screen([[17.5, 1.5], [30.5, 3.5], [20.5, 14.5]], np.full(3, 0.5))] * 150
    for t in rng.choice(n_single, 8, replace=False):
        tris += [tris[t]] * 3
    clip = np.concatenate(tris).astype(np.float32)
    return torch.from_numpy(clip), torch.arange(len(clip), dtype=torch.int32).reshape(-1, 3)


def forward_raster_inputs(scene_arrays, cam_state, scene_static, width: int, height: int,
                          shadow: int, cfg: RasterConfig) -> dict:
    """The camera and sun rasters of the forward frame's first frame, as
    the Geometry and SunShadow passes form them: name -> (setup, bins,
    width, height, depth_only)."""
    sa, cs = scene_arrays, cam_state
    vtx = build_vertex_world(sa, sa.positions, sa.normals, sa.tangents,
                             layout=record_layout_for(scene_static))
    clip = world_to_clip(cs.view_proj, vtx[:, 0:3])
    tri_vis = visible_triangles(sa, cs.view_proj, cs.position)
    cam = raster.setup_triangles(clip, sa.indices, tri_vis, width, height, w_eps=cs.near)
    sun_vp = sa.lights.sun_view_proj
    clip = world_to_clip(sun_vp, vtx[:, 0:3])
    sun = raster.setup_triangles(clip, sa.indices, visible_triangles(sa, sun_vp, cs.position),
                                 shadow, shadow, cull_backfaces=False)
    return {
        "camera": (cam, raster.bin_triangles(cam, width, height, cfg), width, height, False),
        "sun": (sun, raster.bin_triangles(sun, shadow, shadow, cfg), shadow, shadow, True),
    }


def local_shadow_raster_inputs(scene_arrays, cam_state, size: int, cfg: RasterConfig,
                               spot: int = 0):
    """The depth-only raster of spot light ``spot``'s shadow map, as the
    LocalShadow pass forms it: (setup, bins, size, size, True)."""
    sa = scene_arrays
    vp = sa.lights.spot_view_proj[spot]
    clip = transform_vertices_clip(sa, vp, sa.positions)
    setup = raster.setup_triangles(clip, sa.indices, visible_triangles(sa, vp, cam_state.position),
                                   size, size, cull_backfaces=False)
    return setup, raster.bin_triangles(setup, size, size, cfg), size, size, True


def tile_list_pairs(bins) -> tuple[torch.Tensor, torch.Tensor]:
    """Every (tile, triangle) pair stage 4 walks, in walk order: grouped by
    ascending tile, each tile's binned list first, then the global list.
    Returns two (N,) int64 tensors (tile ids, setup rows)."""
    counts = bins.counts.long()
    ntiles = counts.shape[0]
    dev = counts.device
    tile_ids = torch.arange(ntiles, device=dev)
    b_tile = torch.repeat_interleave(tile_ids, counts)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(b_tile.shape[0], device=dev) - first[b_tile]
    b_tri = bins.sorted_tris[bins.starts.long()[b_tile] + pos].long()
    g = bins.global_tris[: int(bins.global_count)].long()
    g_tile = tile_ids.repeat_interleave(g.shape[0])
    g_tri = g.repeat(ntiles)
    tiles = torch.cat([b_tile, g_tile])
    order = torch.sort(tiles, stable=True).indices
    return tiles[order], torch.cat([b_tri, g_tri])[order]


def pixel_tests(setup, bins, width: int, height: int, cfg: RasterConfig) -> tuple[int, int]:
    """Pixel tests of a raster that walks every listed pair, and of one that
    walks only the pairs ``tile_rejects`` keeps."""
    tiles, tris = tile_list_pairs(bins)
    kept = int((~raster.tile_rejects(setup, tiles, tris, width, height, cfg)).sum())
    pixels = cfg.tile_h * cfg.tile_w
    return tiles.numel() * pixels, kept * pixels


def bound_ms(setup, bins, width: int, height: int, depth_only: bool,
             tests: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes the
    kernel must move over the HBM rate and the operations of ``tests``
    pixel tests over the float32 rate. The bytes are each one read or
    written once: every tile's list start and count, the global count, the
    list entries in use (binned, and the global list once), the setup rows
    (corner xy and z) of the distinct triangles the lists name, and the
    depth (and vis) written. The unused capacity of the lists and the
    setup rows no list names are not read."""
    ntiles = bins.counts.numel()
    n_ids = int(bins.counts.sum()) + int(bins.global_count)
    rows = torch.unique(tile_list_pairs(bins)[1]).numel()
    row_bytes = (setup.screen_xy[0].numel() + setup.z_ndc[0].numel()) * 4
    nbytes = ntiles * 8 + 4 + n_ids * 4 + rows * row_bytes
    nbytes += width * height * (4 if depth_only else 8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tests * OPS_PER_TEST / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def events_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls under CUDA
    events, after one warm-up call: host launch cost included."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn) -> float:
    """Device ms per call of ``fn``: GRAPH_LAUNCHES calls captured in one
    CUDA graph, replayed once to warm up and once under CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / GRAPH_LAUNCHES


def kernel_ms(lib, setup, bins, width: int, height: int, cfg: RasterConfig,
              depth_only: bool) -> float:
    """Device ms of one launch of ``lib``'s kernel into outputs made once.
    Between launches the outputs stay in place, and at the camera's size
    (16.6 MB) they stay in the 50 MB L2 as well."""
    dev = setup.screen_xy.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    vis = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    return graph_ms(lambda: raster_cuda.launch_raw(lib, setup, bins, width, height, cfg,
                                                   depth_only, 0, None, depth, vis))


def load_wrapper(root: Path):
    """The ``ops/raster_cuda.py`` module of the checkout at ``root``, under
    another name: it builds that checkout's csrc/ into that checkout's
    build/ and keeps its own library."""
    spec = importlib.util.spec_from_file_location(
        "other_raster_cuda", root / "arkoserenderer_torch" / "ops" / "raster_cuda.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> None:
    from arkoserenderer_torch.assets.procedural import build_test_scene

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, help="root of another checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_bench: torch.cuda.is_available() is False; this needs a GPU")
    dev = torch.device("cuda")
    card = card_line()
    wrappers = {"this": raster_cuda, "other": load_wrapper(args.other.resolve())}
    libs = {which: w.build_kernels() for which, w in wrappers.items()}
    cfg = RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256)
    scene, cam = build_test_scene(viewport=(1920, 1080))
    cases = forward_raster_inputs(scene.build(dev), cam.state(0, dev), scene.static_info(),
                                  1920, 1080, 8192, cfg)
    out = {}
    for name, (setup, bins, w, h, depth_only) in cases.items():
        times = {f"{which}_{kind}": [] for which in wrappers for kind in ("ms", "device_ms")}
        results = {}
        for _ in range(ROUNDS):
            for which in ("other", "this", "this", "other"):
                wrap = wrappers[which].rasterize_tiles_cuda
                results[which] = wrap(setup, bins, w, h, cfg, depth_only=depth_only)
                times[f"{which}_ms"].append(events_ms(
                    lambda: wrap(setup, bins, w, h, cfg, depth_only=depth_only),
                    WRAPPER_CALLS[name]))
                times[f"{which}_device_ms"].append(
                    kernel_ms(libs[which], setup, bins, w, h, cfg, depth_only))
        (ov, od), (tv, td) = results["other"], results["this"]
        torch.cuda.synchronize()
        if not (torch.equal(ov, tv) and torch.equal(od, td)):
            raise AssertionError(f"{name}: this kernel and the other disagree")
        before, after = pixel_tests(setup, bins, w, h, cfg)
        bound, kind = bound_ms(setup, bins, w, h, depth_only, after)
        out[name] = {**times, "pixel_tests_before": before, "pixel_tests_after": after,
                     "bound_ms": bound, "bound_by": kind}
        print(f"{name}: " + ", ".join(f"{k} {sorted(v)}" for k, v in times.items())
              + f"; bound {bound:.4f} ms ({kind}), pixel tests {before} -> {after} [{card}]",
              flush=True)
    print(card)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "cases": out}))


if __name__ == "__main__":
    main()
