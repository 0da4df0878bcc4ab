"""Hand-written CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip without one. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q

Tolerance: equal, bit for bit. The raster kernel is built with
--fmad=false and performs the plain version's operations in its order.
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
