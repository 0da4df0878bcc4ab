"""Exact tile-level rejection (ops/raster.py::tile_rejects), on the CPU.

The raster kernel drops a (tile, triangle) pair at staging when, for some
edge, the normalised barycentric is < 0 at all four corner pixel centres
of the tile. These tests hold that predicate to the plain per-pixel
arithmetic of rasterize_tiles_plain:

  * soundness: no rejected pair has a pixel with all three barycentrics
    >= 0 (exact: the same float32 operations, no tolerance);
  * equivalence: a plain raster that walks only the surviving pairs, in
    walk order, equals rasterize_tiles_plain bit for bit, with depth_only,
    a y_offset band and a depth_limit peel;
  * adversarial inputs (hypothesis): vertices on pixel centres and tile
    borders, zero area, far-off vertices, depth ties;
  * effectiveness: on a sun-like raster at 1024^2, whose floor sits in the
    global list, the pixel tests fall at least five-fold.

No JAX and no card is needed:

    python -m pytest tests/test_torch_raster_reject.py -q -p no:randomly
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from arkoserenderer_torch.assets.procedural import build_test_scene
from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.tools import raster_bench
from test_torch_kernels import W, H, triangles


def covered_pairs(setup, tiles, tris, width, height, cfg, y_offset=0):
    """(N,) bool: the pair has a pixel with l0, l1, l2 >= 0, by the plain
    version's per-pixel arithmetic."""
    px, py = raster._tile_pixel_centers(width, height, cfg, "cpu")
    py = py + y_offset
    px, py = px[tiles], py[tiles]
    s = setup.screen_xy[tris]
    x0, y0 = s[:, 0, 0, None], s[:, 0, 1, None]
    x1, y1 = s[:, 1, 0, None], s[:, 1, 1, None]
    x2, y2 = s[:, 2, 0, None], s[:, 2, 1, None]
    area2 = raster.edge_fn(x0, y0, x1, y1, x2, y2)
    inv = torch.where(torch.abs(area2) > 1e-12, 1.0 / torch.where(area2 == 0, 1.0, area2), 0.0)
    l0 = raster.edge_fn(x1, y1, x2, y2, px, py) * inv
    l1 = raster.edge_fn(x2, y2, x0, y0, px, py) * inv
    l2 = raster.edge_fn(x0, y0, x1, y1, px, py) * inv
    return ((l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0)).any(dim=1)


def survivor_bins(setup, bins, width, height, cfg, y_offset=0):
    """The pairs tile_rejects keeps, as binned-only lists in walk order."""
    tiles, tris = raster_bench.tile_list_pairs(bins)
    keep = ~raster.tile_rejects(setup, tiles, tris, width, height, cfg, y_offset)
    tiles, tris = tiles[keep], tris[keep]
    counts = torch.bincount(tiles, minlength=bins.counts.shape[0])
    i32 = torch.int32
    return raster.TileBins(
        sorted_tris=tris.to(i32), starts=(torch.cumsum(counts, 0) - counts).to(i32),
        counts=counts.to(i32), global_tris=torch.full((1,), -1, dtype=i32),
        global_count=torch.zeros((), dtype=i32), overflow=bins.overflow)


def assert_sound(setup, bins, width, height, cfg, y_offset=0):
    tiles, tris = raster_bench.tile_list_pairs(bins)
    rejected = raster.tile_rejects(setup, tiles, tris, width, height, cfg, y_offset)
    covered = covered_pairs(setup, tiles[rejected], tris[rejected], width, height, cfg, y_offset)
    assert not bool(covered.any()), f"{int(covered.sum())} rejected pairs cover a pixel"
    return int(rejected.sum())


def assert_equivalent(setup, bins, width, height, cfg, depth_only=False, y_offset=0,
                      depth_limit=None):
    kw = dict(depth_only=depth_only, y_offset=y_offset, depth_limit=depth_limit)
    ref_v, ref_d = raster.rasterize_tiles_plain(setup, bins, width, height, cfg, **kw)
    kept = survivor_bins(setup, bins, width, height, cfg, y_offset)
    v, d = raster.rasterize_tiles_plain(setup, kept, width, height, cfg, **kw)
    assert torch.equal(v, ref_v) and torch.equal(d, ref_d)
    return ref_d


# -- random triangles (tests/test_torch_kernels.py's generator) -----------------

def random_setup(seed, floor):
    clip, idx = triangles(np.random.default_rng(seed), 20 if floor else 60, floor)
    cfg = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64,
                       max_tiles_per_tri=4 if floor else 16, max_global_tris=32)
    setup = raster.setup_triangles(clip, idx, torch.ones(len(idx), dtype=torch.bool), W, H,
                                   cull_backfaces=False, w_eps=0.1 if floor else 1e-4)
    return setup, cfg


@pytest.mark.parametrize("seed", [1234, 5, 6])
@pytest.mark.parametrize("floor", [False, True])
def test_rejection_is_sound_on_random_triangles(seed, floor):
    setup, cfg = random_setup(seed, floor)
    for y_off, h in ((0, H), (16, H // 2)):
        bins = raster.bin_triangles(setup, W, h, cfg, y_offset=y_off)
        assert_sound(setup, bins, W, h, cfg, y_off)


# (floor, depth_only, band y_offset, peel), as tests/test_torch_kernels.py
CASES = [
    (False, False, 0, False),
    (False, True, 0, False),
    (True, False, 0, False),
    (True, True, 0, False),
    (False, False, 16, False),
    (False, False, 0, True),
    (True, False, 16, False),
    (True, False, 0, True),
]


@pytest.mark.parametrize("floor,depth_only,y_off,peel", CASES)
def test_surviving_pairs_raster_equals_plain(floor, depth_only, y_off, peel):
    setup, cfg = random_setup(1234, floor)
    h = H // 2 if y_off else H
    bins = raster.bin_triangles(setup, W, h, cfg, y_offset=y_off)
    lim = raster.rasterize_tiles_plain(setup, bins, W, h, cfg, y_offset=y_off)[1] if peel else None
    depth = assert_equivalent(setup, bins, W, h, cfg, depth_only, y_off, lim)
    assert (depth > 0).any()


# -- the forward frame's scene ---------------------------------------------------

_SCENES = {}


def scene_rasters(res, tile_w, sun_res):
    """Camera and sun raster inputs of build_test_scene (cached per size)."""
    key = (res, tile_w, sun_res)
    if key not in _SCENES:
        scene, cam = build_test_scene(viewport=(res, res))
        cfg = RasterConfig(tile_h=8, tile_w=tile_w, max_tris_per_tile=256)
        _SCENES[key] = cfg, raster_bench.forward_raster_inputs(
            scene.build("cpu"), cam.state(0, "cpu"), scene.static_info(), res, res, sun_res, cfg)
    return _SCENES[key]


@pytest.mark.parametrize("res,tile_w", [(96, 16), (256, 128)])
@pytest.mark.parametrize("which", ["camera", "sun"])
def test_rejection_is_sound_on_the_scene(res, tile_w, which):
    cfg, cases = scene_rasters(res, tile_w, res)
    setup, bins, w, h, _ = cases[which]
    assert assert_sound(setup, bins, w, h, cfg) > 0


@pytest.mark.parametrize("which", ["camera", "sun"])
def test_scene_raster_of_surviving_pairs_equals_plain(which):
    cfg, cases = scene_rasters(96, 16, 96)
    setup, bins, w, h, depth_only = cases[which]
    assert_equivalent(setup, bins, w, h, cfg, depth_only)


def test_adversarial_case_of_chip_smoke():
    """chip_smoke.py's adversarial case on the card, here through the plain
    version: sound, equivalent, and with lists longer than one staging
    window of the kernel (128 entries at tile 8x16)."""
    clip, idx = raster_bench.adversarial_case()
    cfg = raster_bench.ADVERSARIAL_CFG
    setup = raster.setup_triangles(clip, idx, torch.ones(len(idx), dtype=torch.bool), 64, 64,
                                   cull_backfaces=False, w_eps=0.1)
    bins = raster.bin_triangles(setup, 64, 64, cfg)
    assert int(bins.counts.max()) + int(bins.global_count) > 2 * 128
    assert int(bins.overflow) == 0 and int(setup.clip_overflow) == 0
    assert assert_sound(setup, bins, 64, 64, cfg) > 0
    first = assert_equivalent(setup, bins, 64, 64, cfg)
    assert_equivalent(setup, bins, 64, 64, cfg, depth_limit=first)


def test_pixel_tests_fall_five_fold_on_a_sun_raster():
    cfg, cases = scene_rasters(256, 16, 1024)
    setup, bins, w, h, _ = cases["sun"]
    assert int(bins.global_count) >= 1
    before, after = raster_bench.pixel_tests(setup, bins, w, h, cfg)
    assert after * 5 <= before, (before, after)


# -- adversarial screen-space triangles (hypothesis) ----------------------------

VW, VH = 32, 32
ADV_CFG = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64, max_tiles_per_tri=2,
                       max_global_tris=32)

_coord_x = st.one_of(
    st.integers(-2, VW + 2).map(lambda k: k + 0.5),           # pixel centres
    st.integers(0, VW // 16).map(lambda k: 16.0 * k),         # tile borders
    st.floats(-40, 72, width=32),
    st.sampled_from([-1e4, 1e4]),
)
_coord_y = st.one_of(
    st.integers(-2, VH + 2).map(lambda k: k + 0.5),
    st.integers(0, VH // 8).map(lambda k: 8.0 * k),
    st.floats(-40, 72, width=32),
    st.sampled_from([-1e4, 1e4]),
)
_vertex = st.tuples(_coord_x, _coord_y)
_triangle = st.one_of(
    st.tuples(_vertex, _vertex, _vertex),
    st.tuples(_vertex, _vertex).map(lambda ab: (ab[0], ab[0], ab[1])),  # zero area
    st.tuples(_vertex, _vertex).map(                                    # collinear
        lambda ab: (ab[0], ab[1], (2 * ab[1][0] - ab[0][0], 2 * ab[1][1] - ab[0][1]))),
)
_scene = st.tuples(
    st.lists(st.tuples(_triangle, st.sampled_from([0.25, 0.5, 0.75])), min_size=1, max_size=10),
    st.lists(st.integers(0, 9), max_size=4),  # triangles to duplicate (depth ties)
)


def screen_setup(tris):
    """A TriSetup straight from screen-space triangles, every one valid."""
    xy = torch.tensor([t for t, _ in tris], dtype=torch.float32)
    z = torch.tensor([[zc] * 3 for _, zc in tris], dtype=torch.float32)
    n = len(tris)
    return raster.TriSetup(
        screen_xy=xy, z_ndc=z, inv_w=torch.ones(n, 3), valid=torch.ones(n, dtype=torch.bool),
        bbox=torch.cat([xy.amin(dim=1), xy.amax(dim=1)], dim=-1),
        orig_tri=torch.arange(n, dtype=torch.int32), corner_bary=torch.zeros(n, 3, 3),
        clip_overflow=torch.zeros((), dtype=torch.int32))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(_scene)
def test_rejection_on_adversarial_triangles(scene):
    tris, dups = scene
    tris = tris + [tris[i % len(tris)] for i in dups]
    setup = screen_setup(tris)
    bins = raster.bin_triangles(setup, VW, VH, ADV_CFG)
    assert_sound(setup, bins, VW, VH, ADV_CFG)
    assert_equivalent(setup, bins, VW, VH, ADV_CFG)


def test_bound_counts_the_bytes_the_kernel_reads():
    """The bound's bytes: list headers, the list entries in use, the setup
    rows they name (each once) and the outputs; not the lists' unused
    capacity nor setup rows no list names."""
    setup, cfg = random_setup(1234, True)
    bins = raster.bin_triangles(setup, W, H, cfg)
    counts, starts = bins.counts.tolist(), bins.starts.tolist()
    g = int(bins.global_count)
    ids = bins.sorted_tris.tolist()
    rows = set(bins.global_tris[:g].tolist())
    for s, c in zip(starts, counts):
        rows.update(ids[s:s + c])
    assert len(ids) > sum(counts) and setup.screen_xy.shape[0] > len(rows)
    for depth_only, out_bytes in ((False, 8), (True, 4)):
        nbytes = len(counts) * 8 + 4 + (sum(counts) + g) * 4 + len(rows) * 36 + W * H * out_bytes
        bound, kind = raster_bench.bound_ms(setup, bins, W, H, depth_only, 0)
        assert kind == "bytes"
        assert bound == pytest.approx(nbytes / raster_bench.HBM_BYTES_PER_S * 1e3, rel=1e-12)
