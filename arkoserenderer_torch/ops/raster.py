"""Tile-based triangle rasterization (port of arkoserenderer_tpu/ops/raster.py).

Four data-parallel stages over static-capacity pools:

  1. ``setup_triangles`` — vertex gather, near-plane clipping, screen
     mapping, backface cull, bbox;
  2. near clipping       — triangles crossing w = eps become 1-2
     sub-triangles; sub-triangles keep their original triangle id and the
     barycentrics of their corners, so shading never sees the clip;
  3. ``bin_triangles``   — (tile, triangle) pairs sorted into per-tile
     lists, plus a global list of big triangles every tile walks;
  4. ``rasterize_tiles`` — z-buffered edge-function raster producing the
     visibility buffer (setup-row id + reverse-Z depth per pixel).

Stage 4 is the one hand-written kernel (csrc/raster_tiles.cu, wrapped by
ops/raster_cuda.py). ``rasterize_tiles`` sends CUDA tensors to it and CPU
tensors to ``rasterize_tiles_plain``, the plain torch version that tests
and chip_smoke.py hold the kernel against. ``tile_rejects`` is the plain
version of the kernel's exact tile-level rejection.
Stages 1-3 are torch ops and never read a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from arkoserenderer_torch.core.types import DEPTH_FAR, VIS_NONE, RasterConfig


class TriSetup(NamedTuple):
    """Per-raster-triangle setup data, (T', ...) with T' = T + clip budget."""

    screen_xy: torch.Tensor    # (T', 3, 2) pixel coords of the 3 corners
    z_ndc: torch.Tensor        # (T', 3) reverse-Z ndc depth per corner
    inv_w: torch.Tensor        # (T', 3) 1/w_clip per corner
    valid: torch.Tensor        # (T',) bool
    bbox: torch.Tensor         # (T', 4) [x0, y0, x1, y1] pixel AABB
    orig_tri: torch.Tensor     # (T',) i32 original triangle id
    corner_bary: torch.Tensor  # (T', 3, 3) corner barycentrics w.r.t. the original
    clip_overflow: torch.Tensor  # () i32 clipped sub-triangles dropped


class TileBins(NamedTuple):
    """Per-tile triangle lists in sorted-pair form:
    ``sorted_tris[starts[t] : starts[t] + counts[t]]`` are tile t's setup
    rows in ascending order; ``global_tris[:global_count]`` every tile walks."""

    sorted_tris: torch.Tensor   # (P,) i32 tri ids grouped by tile
    starts: torch.Tensor        # (ntiles,) i32
    counts: torch.Tensor        # (ntiles,) i32 min(group size, K)
    global_tris: torch.Tensor   # (G,) i32, -1 padded
    global_count: torch.Tensor  # () i32
    overflow: torch.Tensor      # () i32 entries dropped by the K / G / mid caps


def num_tiles(width: int, height: int, cfg: RasterConfig) -> tuple[int, int]:
    if width % cfg.tile_w or height % cfg.tile_h:
        raise ValueError(
            f"viewport {width}x{height} must be a multiple of tile {cfg.tile_w}x{cfg.tile_h}"
        )
    return height // cfg.tile_h, width // cfg.tile_w


def edge_fn(ax, ay, bx, by, px, py):
    """Signed edge function of edge a->b at (px, py): positive inside a
    triangle wound CCW in world (y-up) terms, i.e. CW on the y-down screen."""
    return (by - ay) * (px - ax) - (bx - ax) * (py - ay)


# ---------------------------------------------------------------------------
# Stage 1+2: gather, clip, setup


def _near_clip(tri_clip, tri_valid, w_eps, extra_budget: int):
    """Clip (T,3,4) triangles against w = w_eps.

    Returns (clip (T+E,3,4), corner_bary (T+E,3,3), orig (T+E,), valid
    (T+E,), overflow ()): slot t < T holds triangle t's (possibly clipped)
    replacement, the E extra slots the second halves of quad clips in
    ascending triangle order.
    """
    t_total = tri_clip.shape[0]
    dev = tri_clip.device
    w = tri_clip[..., 3]
    inside = w > w_eps
    n_in = inside.sum(-1)

    # Canonical rotation: n_in == 2 puts the single outside vertex at corner
    # 2, n_in == 1 the single inside vertex at corner 0. argmin/argmax
    # return the first extremum, as in the reference.
    inside8 = inside.to(torch.int8)
    out_idx = torch.argmin(inside8, dim=-1)
    in_idx = torch.argmax(inside8, dim=-1)
    start = torch.where(n_in == 2, (out_idx + 1) % 3, in_idx)
    s3 = start[:, None, None]
    rot = torch.where(
        s3 == 0, tri_clip,
        torch.where(s3 == 1, torch.roll(tri_clip, -1, dims=1),
                    torch.roll(tri_clip, -2, dims=1)))
    eye = torch.eye(3, dtype=tri_clip.dtype, device=dev)
    ident = eye.expand(t_total, 3, 3)
    rot_bary = torch.where(
        s3 == 0, ident,
        torch.where(s3 == 1, torch.roll(eye, -1, dims=0).expand(t_total, 3, 3),
                    torch.roll(eye, -2, dims=0).expand(t_total, 3, 3)))

    a, b, c = rot[:, 0], rot[:, 1], rot[:, 2]
    ba, bb, bc = rot_bary[:, 0], rot_bary[:, 1], rot_bary[:, 2]
    wa, wb, wc = a[:, 3], b[:, 3], c[:, 3]

    def lerp_to_plane(p, q, bp, bq, wp, wq):
        dw = wq - wp
        t = ((w_eps - wp) / torch.where(torch.abs(dw) > 1e-20, dw, 1.0))[:, None]
        t = torch.clamp(t, 0.0, 1.0)
        return p + t * (q - p), bp + t * (bq - bp)

    i_bc, by_bc = lerp_to_plane(b, c, bb, bc, wb, wc)  # n_in == 2: B->C
    i_ac, by_ac = lerp_to_plane(a, c, ba, bc, wa, wc)  #            A->C
    i_ab, by_ab = lerp_to_plane(a, b, ba, bb, wa, wb)  # n_in == 1: A->B

    n_in_b = n_in[:, None, None]
    prim = torch.where(
        n_in_b == 3, tri_clip,
        torch.where(n_in_b == 2, torch.stack([a, b, i_bc], dim=1),
                    torch.stack([a, i_ab, i_ac], dim=1)))
    prim_bary = torch.where(
        n_in_b == 3, ident,
        torch.where(n_in_b == 2, torch.stack([ba, bb, by_bc], dim=1),
                    torch.stack([ba, by_ab, by_ac], dim=1)))
    prim_valid = tri_valid & (n_in > 0)

    # Second triangle of each quad clip, compacted into the E extra slots
    # by one sort of the triangle ids (keys are distinct).
    needs_extra = tri_valid & (n_in == 2)
    extra_tri = torch.stack([a, i_bc, i_ac], dim=1)
    extra_bary = torch.stack([ba, by_bc, by_ac], dim=1)
    ids = torch.arange(t_total, dtype=torch.int64, device=dev)
    key_sorted = torch.sort(torch.where(needs_extra, ids, t_total)).values
    if extra_budget > t_total:
        pad = key_sorted.new_full((extra_budget - t_total,), t_total)
        key_sorted = torch.cat([key_sorted, pad])
    sel = key_sorted[:extra_budget]
    ok = sel < t_total
    src = torch.where(ok, sel, 0)
    okf = ok[:, None, None]
    # Unfilled slots stay exactly zero (w == 0 rows; see clip_to_screen).
    e_clip = torch.where(okf, extra_tri[src], 0.0)
    e_bary = torch.where(okf, extra_bary[src], 0.0)
    e_orig = torch.where(ok, sel, 0)

    clip_all = torch.cat([prim, e_clip], dim=0)
    bary_all = torch.cat([prim_bary, e_bary], dim=0)
    orig_all = torch.cat([ids, e_orig], dim=0).to(torch.int32)
    valid_all = torch.cat([prim_valid, ok], dim=0)
    overflow = torch.clamp(needs_extra.sum() - extra_budget, min=0).to(torch.int32)
    return clip_all, bary_all, orig_all, valid_all, overflow


def clip_to_screen(clip: torch.Tensor, width: int, height: int):
    """(..., 4) clip -> (..., 2) pixel coords, (...,) z_ndc, (...,) inv_w.

    x right, y down, pixel centres at integer + 0.5. The division is guarded
    so pool padding rows (w == 0) stay finite."""
    w = clip[..., 3]
    inv_w = torch.where(torch.abs(w) > 1e-12, 1.0 / torch.where(w == 0, 1.0, w), 0.0)
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    return torch.stack([sx, sy], dim=-1), ndc[..., 2], inv_w


def default_clip_budget(num_tris: int) -> int:
    return max(num_tris // 8, 64)


def setup_triangles(
    clip: torch.Tensor,
    indices: torch.Tensor,
    tri_valid: torch.Tensor,
    width: int,
    height: int,
    cull_backfaces: bool = True,
    w_eps: float | torch.Tensor = 1e-4,
    clip_budget: int | None = None,
) -> TriSetup:
    """Stage 1+2: gather vertices, near-clip at ``w = w_eps`` (the camera's
    near value for perspective views), map to screen, cull, bbox.
    ``indices``: (T, 3) i32; ``tri_valid``: (T,) bool. Front faces are CCW."""
    t_total = indices.shape[0]
    if clip_budget is None:
        clip_budget = default_clip_budget(t_total)
    tri_clip = clip[indices.long()]
    tri_clip, corner_bary, orig_tri, valid, clip_overflow = _near_clip(
        tri_clip, tri_valid, w_eps, clip_budget
    )
    screen, z_ndc, inv_w = clip_to_screen(tri_clip, width, height)

    p0, p1, p2 = screen[:, 0], screen[:, 1], screen[:, 2]
    area2 = edge_fn(p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1])
    facing = area2 > 1e-12 if cull_backfaces else torch.abs(area2) > 1e-12

    bbox = torch.cat([screen.amin(dim=1), screen.amax(dim=1)], dim=-1)
    on_screen = (
        (bbox[:, 2] >= 0.0) & (bbox[:, 3] >= 0.0)
        & (bbox[:, 0] < width) & (bbox[:, 1] < height)
    )
    return TriSetup(
        screen_xy=screen,
        z_ndc=z_ndc.contiguous(),  # the raster kernel reads it as a flat (T', 3) array
        inv_w=inv_w,
        valid=valid & facing & on_screen,
        bbox=bbox,
        orig_tri=orig_tri,
        corner_bary=corner_bary,
        clip_overflow=clip_overflow,
    )


# ---------------------------------------------------------------------------
# Stage 3: binning


def bin_triangles(
    setup: TriSetup,
    width: int,
    height: int,
    cfg: RasterConfig,
    y_offset: int = 0,
) -> TileBins:
    """Stage 3: per-tile triangle lists by one sort of (tile, tri) pairs.

    Every triangle gets 2 pair slots; the few spanning 3..C tiles
    (C = ``max_tiles_per_tri``) are compacted into a side list with C slots
    each; larger ones go to the global list. One sort of the int64 key
    ``tile * (T' + 1) + tri`` orders each tile's list by ascending triangle
    (keys are distinct, so the order is the reference's two-key sort), and
    a searchsorted over the tiles recovers the ranges. ``height`` is the
    band height; ``y_offset`` positions the band in screen space.
    """
    nty, ntx = num_tiles(width, height, cfg)
    ntiles = nty * ntx
    k_cap = cfg.max_tris_per_tile
    c = cfg.max_tiles_per_tri
    g_cap = cfg.max_global_tris
    t_total = setup.valid.shape[0]
    dev = setup.valid.device
    bbox = setup.bbox

    def tile_of(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int64)

    tx0 = tile_of(bbox[:, 0], cfg.tile_w, ntx)
    ty0 = tile_of(bbox[:, 1] - y_offset, cfg.tile_h, nty)
    tx1 = tile_of(bbox[:, 2], cfg.tile_w, ntx)
    ty1 = tile_of(bbox[:, 3] - y_offset, cfg.tile_h, nty)
    in_band = (bbox[:, 3] >= y_offset) & (bbox[:, 1] < y_offset + height)
    valid = setup.valid & in_band

    span_x = tx1 - tx0 + 1
    span = span_x * (ty1 - ty0 + 1)
    big = valid & (span > c)
    overflow_mid = torch.zeros((), dtype=torch.int64, device=dev)

    def emit(ids, n_slots, ok_mask, _tx0, _ty0, _sx, _span):
        """(N,) tri ids -> (N*n_slots,) tile keys + tri values."""
        ks = torch.arange(n_slots, dtype=torch.int64, device=dev)[None, :]
        sx = torch.clamp(_sx, min=1)[:, None]
        tile = (_ty0[:, None] + ks // sx) * ntx + (_tx0[:, None] + ks % sx)
        pair_ok = ok_mask[:, None] & (ks < _span[:, None])
        k = torch.where(pair_ok, tile, ntiles).reshape(-1)  # invalid -> end
        v = ids[:, None].expand(ids.shape[0], n_slots).reshape(-1)
        return k, v

    c_a = min(2, c)
    all_ids = torch.arange(t_total, dtype=torch.int64, device=dev)
    keys, tris = emit(all_ids, c_a, valid & (span <= c_a), tx0, ty0, span_x, span)
    if c > c_a:
        m_cap = max(t_total // 8, 2048)  # span-3..C budget (the reference default)
        mid = valid & (span > c_a) & (span <= c)
        mid_sorted = torch.sort(torch.where(mid, all_ids, t_total)).values
        if m_cap > t_total:
            mid_sorted = torch.cat([mid_sorted, mid_sorted.new_full((m_cap - t_total,), t_total)])
        sel = mid_sorted[:m_cap]
        ok = sel < t_total
        src = torch.where(ok, sel, 0)
        keys_b, tris_b = emit(sel, c, ok, tx0[src], ty0[src], span_x[src], span[src])
        keys = torch.cat([keys, keys_b])
        tris = torch.cat([tris, tris_b])
        overflow_mid = torch.clamp(mid.sum() - m_cap, min=0)

    stride = t_total + 1  # tri values run up to t_total (the empty slot id)
    packed = torch.sort(keys * stride + tris).values
    sorted_keys = packed // stride
    sorted_tris = (packed % stride).to(torch.int32)

    bounds = torch.arange(ntiles + 1, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_keys, bounds, right=False)
    raw_counts = starts[1:] - starts[:-1]
    counts = torch.clamp(raw_counts, max=k_cap)
    overflow = torch.sum(raw_counts - counts)

    big_sorted = torch.sort(torch.where(big, all_ids, t_total)).values
    if t_total < g_cap:
        big_sorted = torch.cat([big_sorted, big_sorted.new_full((g_cap - t_total,), t_total)])
    n_big = big.sum()
    g_count = torch.clamp(n_big, max=g_cap)
    slots = torch.arange(g_cap, dtype=torch.int64, device=dev)
    global_tris = torch.where(slots < g_count, big_sorted[:g_cap], VIS_NONE)
    overflow = overflow + (n_big - g_count) + overflow_mid

    return TileBins(
        sorted_tris=sorted_tris,
        starts=starts[:-1].to(torch.int32),
        counts=counts.to(torch.int32),
        global_tris=global_tris.to(torch.int32),
        global_count=g_count.to(torch.int32),
        overflow=overflow.to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Stage 4: per-tile raster


def _tile_pixel_centers(width: int, height: int, cfg: RasterConfig, device):
    """Pixel-centre coords for every tile: two (ntiles, P) arrays."""
    nty, ntx = num_tiles(width, height, cfg)
    f32 = dict(dtype=torch.float32, device=device)
    ty = torch.arange(nty, **f32).repeat_interleave(ntx)
    tx = torch.arange(ntx, **f32).repeat(nty)
    iy = torch.arange(cfg.tile_h, **f32).repeat_interleave(cfg.tile_w)
    ix = torch.arange(cfg.tile_w, **f32).repeat(cfg.tile_h)
    px = tx[:, None] * cfg.tile_w + ix[None, :] + 0.5
    py = ty[:, None] * cfg.tile_h + iy[None, :] + 0.5
    return px, py


def tiled_to_image(tiled: torch.Tensor, width: int, height: int, cfg: RasterConfig):
    """(ntiles, tile_h*tile_w, ...) -> (H, W, ...)."""
    nty, ntx = num_tiles(width, height, cfg)
    x = tiled.reshape((nty, ntx, cfg.tile_h, cfg.tile_w) + tuple(tiled.shape[2:]))
    return x.transpose(1, 2).reshape((height, width) + tuple(tiled.shape[2:]))


def image_to_tiled(img: torch.Tensor, cfg: RasterConfig):
    """(H, W, ...) -> (ntiles, tile_h*tile_w, ...)."""
    h, w = img.shape[0], img.shape[1]
    nty, ntx = h // cfg.tile_h, w // cfg.tile_w
    x = img.reshape((nty, cfg.tile_h, ntx, cfg.tile_w) + tuple(img.shape[2:]))
    return x.transpose(1, 2).reshape((nty * ntx, cfg.tile_h * cfg.tile_w) + tuple(img.shape[2:]))


def rasterize_tiles_plain(
    setup: TriSetup,
    bins: TileBins,
    width: int,
    height: int,
    cfg: RasterConfig,
    depth_only: bool = False,
    y_offset: int = 0,
    depth_limit: torch.Tensor | None = None,
):
    """Stage 4 in plain torch: the kernel's reference version.

    Walks every tile's list position by position (all tiles at once), then
    the global list, keeping the closest coverage per pixel: a fragment
    wins where ``d > depth`` (strict, so the earlier triangle wins ties)
    and ``d < depth_limit`` (the depth-peeling hook). The arithmetic is the
    kernel's, operation for operation, so on the card the two agree bit for
    bit. The loop bounds are read back to the host: this version serves the
    CPU and the comparisons, never the frame on the card.

    Returns (vis (H,W) i32 setup-row ids, depth (H,W) f32 reverse-Z); vis
    is all VIS_NONE when ``depth_only``.
    """
    dev = setup.screen_xy.device
    px, py = _tile_pixel_centers(width, height, cfg, dev)
    py = py + y_offset
    if depth_limit is not None:
        limit_t = image_to_tiled(depth_limit, cfg)
    else:
        limit_t = torch.full_like(px, 2.0)  # no limit
    depth = torch.full_like(px, DEPTH_FAR)
    vis = torch.full(px.shape, VIS_NONE, dtype=torch.int32, device=dev)
    sxy, zn = setup.screen_xy, setup.z_ndc

    def shade_tri(t, active, depth, vis):
        s = sxy[t]  # (ntiles, 3, 2)
        x0, y0 = s[:, 0, 0, None], s[:, 0, 1, None]
        x1, y1 = s[:, 1, 0, None], s[:, 1, 1, None]
        x2, y2 = s[:, 2, 0, None], s[:, 2, 1, None]
        e0 = edge_fn(x1, y1, x2, y2, px, py)
        e1 = edge_fn(x2, y2, x0, y0, px, py)
        e2 = edge_fn(x0, y0, x1, y1, px, py)
        area2 = edge_fn(x0, y0, x1, y1, x2, y2)
        inv_area = torch.where(
            torch.abs(area2) > 1e-12, 1.0 / torch.where(area2 == 0, 1.0, area2), 0.0
        )
        l0, l1, l2 = e0 * inv_area, e1 * inv_area, e2 * inv_area
        z = zn[t]
        d = l0 * z[:, 0, None] + l1 * z[:, 1, None] + l2 * z[:, 2, None]
        covered = ((l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (d > depth)
                   & (d < limit_t) & active[:, None])
        return torch.where(covered, d, depth), torch.where(covered, t[:, None].to(torch.int32), vis)

    counts = bins.counts
    last = bins.sorted_tris.shape[0] - 1
    for i in range(int(counts.max()) if counts.numel() else 0):
        t = bins.sorted_tris[torch.clamp(bins.starts.long() + i, max=last)].long()
        depth, vis = shade_tri(t, i < counts, depth, vis)
    all_tiles = torch.ones(px.shape[0], dtype=torch.bool, device=dev)
    for j in range(int(bins.global_count)):
        t = bins.global_tris[j].long().expand(px.shape[0])
        depth, vis = shade_tri(t, all_tiles, depth, vis)

    depth = tiled_to_image(depth, width, height, cfg)
    if depth_only:
        vis = torch.full((height, width), VIS_NONE, dtype=torch.int32, device=dev)
    else:
        vis = tiled_to_image(vis, width, height, cfg)
    return vis, depth


def tile_rejects(
    setup: TriSetup,
    tile_ids: torch.Tensor,
    tri_ids: torch.Tensor,
    width: int,
    height: int,
    cfg: RasterConfig,
    y_offset: int = 0,
) -> torch.Tensor:
    """Exact tile-level rejection: (N,) bool, True where the triangle
    ``tri_ids[i]`` covers no pixel of tile ``tile_ids[i]``.

    It evaluates each edge's normalised barycentric ``l_i = fl(edge_fn(...)
    * inv_area)`` at the tile's four corner pixel centres, with the
    operations of ``rasterize_tiles_plain`` in its order, and rejects the
    pair when, for some edge, all four corner values are ``< 0``.

    Why this is exact, for the rounded arithmetic the kernel performs: with
    the triangle fixed, ``fl(px - ax)`` is monotone in ``px`` and
    ``fl(A * u)`` in ``u`` (direction set by the sign of ``A``);
    ``fl(T1 - T2)`` is monotone in each argument and ``fl(e * inv)`` in
    ``e``. So the rounded ``l_i`` is monotone along every row and every
    column of the tile's pixel centres, and its maximum over the tile lies
    at a corner: a rejected pair has ``l_i < 0`` at every pixel and covers
    none. A NaN corner never rejects (``NaN < 0`` is false). NaN can only
    arise at one end of a monotone row or column (an infinite term meeting
    another), so corners free of NaN leave the whole tile free of it.
    """
    _, ntx = num_tiles(width, height, cfg)
    dev = setup.screen_xy.device
    f32 = dict(dtype=torch.float32, device=dev)
    tiles = tile_ids.long()
    tx = (tiles % ntx).to(torch.float32)[:, None]
    ty = (tiles // ntx).to(torch.float32)[:, None]
    # The corner pixel centres, formed as _tile_pixel_centers forms them.
    ix = torch.tensor([0, cfg.tile_w - 1, 0, cfg.tile_w - 1], **f32)
    iy = torch.tensor([0, 0, cfg.tile_h - 1, cfg.tile_h - 1], **f32)
    px = tx * cfg.tile_w + ix[None, :] + 0.5
    py = ty * cfg.tile_h + iy[None, :] + 0.5 + y_offset
    s = setup.screen_xy[tri_ids.long()]
    x0, y0 = s[:, 0, 0, None], s[:, 0, 1, None]
    x1, y1 = s[:, 1, 0, None], s[:, 1, 1, None]
    x2, y2 = s[:, 2, 0, None], s[:, 2, 1, None]
    area2 = edge_fn(x0, y0, x1, y1, x2, y2)
    inv_area = torch.where(
        torch.abs(area2) > 1e-12, 1.0 / torch.where(area2 == 0, 1.0, area2), 0.0
    )
    rejects = torch.zeros(tiles.shape, dtype=torch.bool, device=dev)
    for e in (edge_fn(x1, y1, x2, y2, px, py), edge_fn(x2, y2, x0, y0, px, py),
              edge_fn(x0, y0, x1, y1, px, py)):
        rejects |= ((e * inv_area) < 0.0).all(dim=1)
    return rejects


def rasterize_tiles(
    setup: TriSetup,
    bins: TileBins,
    width: int,
    height: int,
    cfg: RasterConfig,
    depth_only: bool = False,
    y_offset: int = 0,
    depth_limit: torch.Tensor | None = None,
):
    """Stage 4: CUDA tensors go to the hand-written kernel, CPU tensors to
    ``rasterize_tiles_plain``; any other device raises. Same contract as
    ``rasterize_tiles_plain``."""
    dev = setup.screen_xy.device
    if dev.type == "cuda":
        from arkoserenderer_torch.ops.raster_cuda import rasterize_tiles_cuda

        return rasterize_tiles_cuda(setup, bins, width, height, cfg, depth_only=depth_only,
                                    y_offset=y_offset, depth_limit=depth_limit)
    if dev.type == "cpu":
        return rasterize_tiles_plain(setup, bins, width, height, cfg, depth_only=depth_only,
                                     y_offset=y_offset, depth_limit=depth_limit)
    raise NotImplementedError(f"rasterize_tiles has no path for device {dev}")
