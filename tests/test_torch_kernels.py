"""Hand-written CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip without one. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q

Tolerance: equal, bit for bit. The kernels are built with --fmad=false
and perform the plain versions' operations in their order.
"""

import numpy as np
import pytest
import torch

from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.ops import raster

W, H = 64, 64


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the raster kernel has no CPU mode")
    return torch.device("cuda")


def triangles(rng, n, floor: bool):
    """n random triangles in front of the camera (+ a huge clipped floor)."""
    centers = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(-10, -2, n)], -1
    )
    verts = (centers[:, None] + rng.normal(size=(n, 3, 3)) * 0.8).reshape(-1, 3)
    if floor:
        verts = np.concatenate([verts, [[-50, -1, 50], [50, -1, 50], [0, -1, -50]]])
    verts = verts.astype(np.float32)
    proj = mx.perspective_reverse_z(np.radians(70.0), W / H, 0.1, 100.0)
    clip = np.concatenate(
        [verts @ proj[:3, :3].T + proj[:3, 3], (verts @ proj[3, :3] + proj[3, 3])[:, None]], -1
    ).astype(np.float32)
    return torch.from_numpy(clip), torch.arange(len(verts), dtype=torch.int32).reshape(-1, 3)


# (floor, depth_only, band y_offset, peel)
CASES = [
    (False, False, 0, False),
    (False, True, 0, False),
    (True, False, 0, False),
    (True, True, 0, False),
    (False, False, 16, False),
    (False, False, 0, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("floor,depth_only,y_off,peel", CASES)
def test_raster_kernel_matches_plain(cuda_device, floor, depth_only, y_off, peel):
    from arkoserenderer_torch.ops.raster_cuda import rasterize_tiles_cuda

    clip, idx = triangles(np.random.default_rng(1234), 20 if floor else 60, floor)
    cfg = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64,
                       max_tiles_per_tri=4 if floor else 16, max_global_tris=32)
    h = H // 2 if y_off else H
    valid = torch.ones(len(idx), dtype=torch.bool, device=cuda_device)
    setup = raster.setup_triangles(clip.to(cuda_device), idx.to(cuda_device), valid, W, H,
                                   cull_backfaces=False, w_eps=0.1 if floor else 1e-4)
    bins = raster.bin_triangles(setup, W, h, cfg, y_offset=y_off)
    lim = raster.rasterize_tiles_plain(setup, bins, W, h, cfg, y_offset=y_off)[1] if peel else None
    before = rasterize_tiles_cuda.launches
    kv, kd = raster.rasterize_tiles(setup, bins, W, h, cfg, depth_only=depth_only,
                                    y_offset=y_off, depth_limit=lim)
    pv, pd = raster.rasterize_tiles_plain(setup, bins, W, h, cfg, depth_only=depth_only,
                                          y_offset=y_off, depth_limit=lim)
    torch.cuda.synchronize()
    assert rasterize_tiles_cuda.launches == before + 1
    assert (kd > 0).any()
    assert torch.equal(kv, pv) and torch.equal(kd, pd)


# (tile_h, tile_w, taken by the kernel)
TILES = [
    (8, 16, True),
    (8, 128, True),
    (32, 64, True),
    (32, 128, False),
    (64, 64, False),
    (8, 256, False),
]


def tile_inputs(device, cfg, width=256, height=64):
    clip, idx = triangles(np.random.default_rng(5), 60, False)
    valid = torch.ones(len(idx), dtype=torch.bool, device=device)
    setup = raster.setup_triangles(clip.to(device), idx.to(device), valid, width, height,
                                   cull_backfaces=False, w_eps=1e-4)
    return setup, raster.bin_triangles(setup, width, height, cfg)


@pytest.mark.parametrize("tile_h,tile_w,taken", TILES)
def test_wrapper_refuses_tiles_the_kernel_does_not_take(tile_h, tile_w, taken):
    """check_tile states the kernel's tile rule; the wrapper raises its
    ValueError before it looks at the inputs, so this runs on the CPU."""
    from arkoserenderer_torch.ops.raster_cuda import check_tile, rasterize_tiles_cuda

    cfg = RasterConfig(tile_h=tile_h, tile_w=tile_w)
    if taken:
        check_tile(cfg)
        return
    with pytest.raises(ValueError, match="does not take tile"):
        check_tile(cfg)
    setup, bins = tile_inputs("cpu", cfg)
    with pytest.raises(ValueError, match="does not take tile"):
        rasterize_tiles_cuda(setup, bins, 256, 64, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_h,tile_w,taken", TILES)
def test_kernel_tile_rule_matches_check_tile(cuda_device, tile_h, tile_w, taken):
    """The C entry point takes exactly the tiles check_tile passes, and
    equals the plain version on them."""
    from arkoserenderer_torch.ops.raster_cuda import build_kernels, launch_raw

    cfg = RasterConfig(tile_h=tile_h, tile_w=tile_w)
    setup, bins = tile_inputs(cuda_device, cfg)
    depth = torch.empty((64, 256), dtype=torch.float32, device=cuda_device)
    vis = torch.empty((64, 256), dtype=torch.int32, device=cuda_device)
    args = (build_kernels(), setup, bins, 256, 64, cfg, False, 0, None, depth, vis)
    if not taken:
        with pytest.raises(ValueError, match="refused tile"):
            launch_raw(*args)
        return
    launch_raw(*args)
    pv, pd = raster.rasterize_tiles_plain(setup, bins, 256, 64, cfg)
    torch.cuda.synchronize()
    assert torch.equal(vis, pv) and torch.equal(depth, pd)


# -- the BVH traversal kernel (csrc/bvh_trace.cu) ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit,per_ray", [(False, False), (False, True), (True, False),
                                             (True, True)])
def test_trace_kernel_matches_plain(cuda_device, any_hit, per_ray):
    """Random rays through a 512-instance TLAS: t, tri, u, v and hit equal
    bit for bit (tools/trace_bench.compare raises otherwise)."""
    from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda
    from arkoserenderer_torch.tools import trace_bench

    bvh, o, d, tm = trace_bench.tlas_case(cuda_device, n_inst=512, n_rays=8192)
    before = trace_rays_cuda.launches
    res = trace_bench.compare(bvh, o, d, tm if per_ray else 1e30, any_hit, "tlas512")
    assert trace_rays_cuda.launches == before + 1
    assert 0.05 < res["hit_share"] < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("max_steps", [9, 20, 512])
def test_trace_kernel_stack_overflow_matches_plain(cuda_device, max_steps):
    """The hand-made chain that overflows the 64-entry stack, cut at 9 and
    20 steps or run out: kernel and plain version agree bit for bit."""
    from arkoserenderer_torch.ops import bvh as bvh_ops
    from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda
    from arkoserenderer_torch.tools.trace_bench import overflow_case

    bvh, o, d = overflow_case(cuda_device)
    k = trace_rays_cuda(bvh, o, d, max_steps=max_steps)
    p = bvh_ops.trace_wide_plain(bvh, o, d, max_steps=max_steps)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


EDGE = [(any_hit, n, True) for any_hit in (False, True) for n in (0, 1, 33, 4099)]
EDGE += [(False, 4099, False), (True, 4099, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit,n,per_ray", EDGE)
def test_trace_kernel_edge_rays_match_plain(cuda_device, any_hit, n, per_ray):
    """tools/trace_bench.edge_cases on the card: ray counts that are no
    multiple of a group or a block, zero and -0.0 direction components,
    -0.0 origins, t_max inf and 0, origins inside instance boxes; bit for
    bit against the plain walk."""
    from arkoserenderer_torch.tools import trace_bench

    case = next(c for c in trace_bench.edge_cases(cuda_device)
                if c["any_hit"] == any_hit and c["origins"].shape[0] == n
                and isinstance(c["t_max"], torch.Tensor) == per_ray)
    trace_bench.compare(case["bvh"], case["origins"], case["directions"], case["t_max"],
                        any_hit, case["label"])


@pytest.mark.cuda
def test_trace_kernel_probe_rays_match_plain(cuda_device):
    """The DDGI-shaped probe case (262,144 closest-hit rays through the rt
    scene), bit for bit against the plain walk."""
    from arkoserenderer_torch.tools import bench, trace_bench

    renderer = bench.build_renderer("rt", small=True, device=cuda_device)
    case = trace_bench.probe_trace(renderer)
    res = trace_bench.compare(renderer.scene_arrays.bvh, case["origins"], case["directions"],
                              case["t_max"], False, case["label"])
    assert res["rays"] == 262144 and 0.05 < res["hit_share"] < 1.0


@pytest.mark.cuda
def test_trace_kernel_ddgi_traces_match_plain(cuda_device):
    """The four DDGI traces of a small flagship frame (64 probes x 128
    rays: the probe rays, then the sun's and the two casting spots'
    occlusion rays at their hits), captured as the frame makes them, bit
    for bit against the plain walk; the frame launched each by its label."""
    from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda
    from arkoserenderer_torch.tools import bench, trace_bench

    renderer = bench.build_renderer("flagship", small=True, device=cuda_device)
    trace_rays_cuda.launches_by_label.clear()
    cases = trace_bench.ddgi_traces(renderer)
    labels = ["ddgi probe", "ddgi sun", "ddgi spot 0", "ddgi spot 1"]
    assert [c["trace"] for c in cases] == labels
    assert [c["label"] for c in cases] == [f"flagship {label}" for label in labels]
    for case in cases:
        res = trace_bench.checked(renderer.scene_arrays.bvh, case)
        assert res["rays"] == 64 * 128
    for label in labels:
        assert trace_rays_cuda.launches_by_label[label] == renderer.frame_index


@pytest.mark.cuda
def test_kernels_on_the_animated_ddgi_frame_match_plain(cuda_device):
    """A small ddgi frame (skinned box, morphed sphere, BVHRefit): its two
    DDGI traces, captured as the frame makes them, walk the BVH refitted in
    that frame and match the plain walk bit for bit; its camera and sun
    rasters, from the skinned and morphed pool, match the plain raster."""
    from arkoserenderer_torch.ops.raster_cuda import rasterize_tiles_cuda
    from arkoserenderer_torch.tools import bench, raster_bench, trace_bench

    renderer = bench.build_renderer("ddgi", small=True, device=cuda_device)
    renderer.render_frame()
    rasters, cases = raster_bench.capture_rasters(
        lambda: trace_bench.kind_traces(renderer, "ddgi"))
    assert [c["trace"] for c in cases] == ["ddgi probe", "ddgi sun"]
    for case in cases:
        assert case["bvh"] is not renderer.scene_arrays.bvh
        assert trace_bench.checked(case["bvh"], case)["rays"] == 64 * 128
    assert sorted(rasters) == [(256, 256, False), (256, 256, True)]
    cfg = renderer.cfg.raster
    for setup, bins, w, h, depth_only in rasters.values():
        kv, kd = rasterize_tiles_cuda(setup, bins, w, h, cfg, depth_only=depth_only)
        pv, pd = raster.rasterize_tiles_plain(setup, bins, w, h, cfg, depth_only=depth_only)
        assert torch.equal(kv, pv) and torch.equal(kd, pd)


def test_trace_wrapper_checks_its_inputs():
    """The wrapper raises on what the kernel does not take before it builds
    anything, so this runs on the CPU."""
    from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda
    from arkoserenderer_torch.tools.trace_bench import overflow_case

    bvh, o, d = overflow_case("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        trace_rays_cuda(bvh, o, d)


# -- the frame record's kernels (csrc/frame_record.cu) ---------------------------


@pytest.mark.cuda
def test_frame_record_kernels_match_the_host_path(cuda_device, monkeypatch):
    """The record's timestamp and counter kernels write what its CPU path
    writes: the frame index in row index % R, the counters reset at the
    frame's first stamp and summed from int32 and int64 values, the stamps in
    order. A CUDA graph of one frame's writes, replayed with two frame-index
    inputs, writes both rows: the row is chosen on the device."""
    from arkoserenderer_torch.utils import profiling

    monkeypatch.setattr(profiling, "RECORD_FRAMES", 4)
    rows = {}
    for dev in ("cpu", cuda_device):
        rec = profiling.FrameRecord(["A", "B"], dev)
        for frame in (2, 9, 6):
            fi = torch.tensor(frame, dtype=torch.int32, device=dev)
            rec.stamp(fi, 0)
            rec.count(fi, "geometry.kept", torch.tensor(frame, device=dev))
            rec.count(fi, "geometry.kept", torch.tensor(5, dtype=torch.int32, device=dev))
            rec.stamp(fi, 1)
            rec.stamp(fi, 2)
        rows[str(dev)] = rec.rows()
    host, card = rows["cpu"], rows[str(cuda_device)]
    assert card["frame_index"].tolist() == host["frame_index"].tolist() == [6, 9]
    assert card["counters"]["geometry.kept"].tolist() == [11, 14]
    assert card["clock"] == "globaltimer" and (np.diff(card["stamps_ns"], axis=1) >= 0).all()

    rec = profiling.FrameRecord(["A"], cuda_device)
    fi = torch.zeros((), dtype=torch.int32, device=cuda_device)
    value = torch.zeros((), dtype=torch.int64, device=cuda_device)
    rec.stamp(fi, 0)  # the launches' first run outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rec.stamp(fi, 0)
        rec.count(fi, "raster.sun_binned", value * 3)
        rec.stamp(fi, 1)
    for frame in (1, 2):
        fi.fill_(frame)
        value.fill_(frame)
        graph.replay()
    got = rec.rows()
    assert got["frame_index"].tolist() == [0, 1, 2]
    assert got["counters"]["raster.sun_binned"].tolist() == [0, 3, 6]
