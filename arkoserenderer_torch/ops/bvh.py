"""BVHs: the host builds and the traversals (port of
arkoserenderer_tpu/ops/bvh.py).

The builds run on the host in numpy, as the reference's do, and every array
they make equals the reference build's (ints equal, floats and the bit-cast
record rows bit for bit); ``build_two_level`` and ``build_bvh`` then move
the arrays to the device once.

``build_two_level``: one BLAS per unique geometry in object space,
binned-SAH binary trees with 4-aligned quad leaves, a TLAS over the
instances' world AABBs, and the whole pool collapsed to branching factor 8
(``_collapse_wide``). The 8-wide walk reads three packed int32 record rows a
step (``wide_rec``, ``quad_rec``, ``inst_rec``; floats travel bit-cast).
``build_bvh`` is the flat single-level tree over world-space triangles
(``FlatBVH``), the kind the reference's AO bake and path tracer take by
their signatures; a scene built without a BVH carries a one-leaf one.

``refit_bvh`` is the per-frame refit of an animated scene, on the device:
the same topology with new bounds. For a two-level BVH the deformable
BLASes' triangles are re-read from the deformed vertex pool, the instance
transforms and the TLAS follow the scene's world matrices, and the records
are re-derived (``_derive_packed``, ``_derive_wide_bounds``,
``_derive_wide_recs``: torch functions the host build calls too, so the
layout has one source); a flat BVH re-reads every triangle.

``trace_rays`` dispatches as the reference's does: a ``FlatBVH`` goes to the
flat lockstep walk (``trace_flat_plain``), a ``TwoLevelBVH`` without wide
records (``wide_meta`` None) to the binary packed-record walk
(``_trace_two_level_plain``); both are torch ops on any device, as the
reference computes them in XLA outside any kernel. Every other BVH takes the
8-wide walk: the hand-written CUDA kernel (``ops/bvh_cuda.trace_rays_cuda``)
for CUDA tensors, its plain torch version ``trace_wide_plain`` for CPU
tensors. ``trace_rays_brute`` is the reference's O(R x T) numpy oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

LEAF_SIZE = 4
STACK_DEPTH = 48        # the flat and binary walks' per-ray stack
WIDE_WIDTH = 8
WIDE_STACK_DEPTH = 64

# Float constants of the traversal arithmetic, as float32 (the kernel uses
# the same literals with an f suffix).
DIR_EPS = float(np.float32(1e-12))     # |d| guard of 1/d, and the |det| test
BARY_EPS = float(np.float32(1e-6))     # barycentric slack
ONE_PLUS_EPS = float(np.float32(1.0 + 1e-6))
NO_KEY = float(np.float32(1e30))       # slab key of a child that is not pushed
# The 19 compare-exchanges of Batcher's 8-sort (the reference's network).
SORT_NET = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
            (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6), (2, 4), (3, 5), (3, 4))


class Hit(NamedTuple):
    t: torch.Tensor    # (R,) hit distance (t_max if miss)
    tri: torch.Tensor  # (R,) i32 global triangle id (-1 = miss)
    u: torch.Tensor    # (R,) barycentric u (of v1)
    v: torch.Tensor    # (R,) barycentric v (of v2)
    hit: torch.Tensor  # (R,) bool


class FlatBVH(NamedTuple):
    """The reference's flat single-level BVH, field for field: a binary
    tree over world-space triangles. ``count`` 0 = internal (children
    ``left``, ``right``), > 0 = leaf of ``count`` triangles from slot
    ``left``; every node's triangles are the slots [node_start, node_end)."""

    node_min: torch.Tensor    # (M, 3) f32
    node_max: torch.Tensor    # (M, 3) f32
    left: torch.Tensor        # (M,) i32
    right: torch.Tensor       # (M,) i32
    count: torch.Tensor       # (M,) i32
    node_start: torch.Tensor  # (M,) i32
    node_end: torch.Tensor    # (M,) i32
    tri_order: torch.Tensor   # (T,) i32 triangle id of each slot
    tri_v0: torch.Tensor      # (T, 3) f32 world-space v0, in slot order
    tri_e1: torch.Tensor      # (T, 3) f32 v1 - v0
    tri_e2: torch.Tensor      # (T, 3) f32 v2 - v0


@dataclasses.dataclass(frozen=True)
class TwoLevelBVH:
    """The reference's two-level structure, field for field. Node pool rows
    [0, n_tlas) are TLAS nodes (world space), the rest BLAS nodes (object
    space); ``count`` 0 = internal, > 0 = triangle leaf, -1 = instance leaf.
    Instance slots past the scene's instances are parked (``inst_active``
    False: tiny boxes at -1e9 reserved for streaming). The traversal reads
    only ``wide_rec`` (W, 56) [8 child bounds f32x48 | 8 descriptors],
    ``quad_rec`` (Q, 40) [4 x (v0, e1, e2) f32x36 | 4 local ids] and
    ``inst_rec`` (I + 1, 14) [w2o f32x12 | triangle base | wide BLAS root]
    (row 0 the identity). The wide fields may be None, as the reference's
    may: such a BVH takes the binary walk over ``node_int``,
    ``node_cbounds`` and ``tri_quad``."""

    node_min: torch.Tensor
    node_max: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    count: torch.Tensor
    node_start: torch.Tensor
    node_end: torch.Tensor
    tri_order: torch.Tensor
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    slot_inst: torch.Tensor
    inst_order: torch.Tensor
    inst_w2o: torch.Tensor
    inst_o2w: torch.Tensor
    blas_root: torch.Tensor
    inst_tri_base: torch.Tensor
    inst_id: torch.Tensor
    node_cbounds: torch.Tensor
    node_int: torch.Tensor
    tri_quad: torch.Tensor
    wide_meta: torch.Tensor | None = None
    wide_src: torch.Tensor | None = None
    wide_cbounds: torch.Tensor | None = None
    wide_root_blas: torch.Tensor | None = None
    wide_rec: torch.Tensor | None = None
    quad_rec: torch.Tensor | None = None
    inst_rec: torch.Tensor | None = None
    inst_active: torch.Tensor | None = None
    n_tlas: int = 1


ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(TwoLevelBVH) if f.name != "n_tlas")


def bvh_from_host(fields: dict, device) -> TwoLevelBVH | FlatBVH:
    """A BVH on ``device`` from host arrays keyed by field name (copies):
    a TwoLevelBVH when they hold its ``node_int`` (a missing wide field is
    None; ``n_tlas`` an int or a 0-d array), else a FlatBVH."""
    def dev(k):
        return torch.from_numpy(np.array(fields[k], copy=True)).to(device)

    if "node_int" not in fields:
        return FlatBVH(*(dev(k) for k in FlatBVH._fields))
    arrays = {k: dev(k) for k in ARRAY_FIELDS if k in fields}
    return TwoLevelBVH(**arrays, n_tlas=int(np.asarray(fields["n_tlas"])))


# ---------------------------------------------------------------------------
# Host build (numpy; every step is the reference's)


def _median_build(lo: np.ndarray, hi: np.ndarray, leaf_size: int,
                  method: str = "sah", sah_bins: int = 16):
    """Top-down tree build over primitive AABBs (lo/hi: (n, 3)): binned SAH
    along the widest centroid axis, falling back to the median split when
    SAH cannot separate. Returns (node_min, node_max, left, right, count,
    node_start, node_end, order): every node's primitives are the range
    [node_start, node_end) of ``order``; a leaf's ``left`` is its first slot
    and ``count`` its length."""
    centroid = 0.5 * (lo + hi)
    n = lo.shape[0]
    max_nodes = 2 * n
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros((max_nodes,), np.int32)
    right = np.zeros((max_nodes,), np.int32)
    count = np.zeros((max_nodes,), np.int32)
    node_start = np.zeros((max_nodes,), np.int32)
    node_end = np.zeros((max_nodes,), np.int32)

    def half_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    order = np.arange(n)
    n_nodes = 1
    stack: list[tuple[int, int, int]] = [(0, 0, n)]  # (node, slice of order)
    while stack:
        node, s, e = stack.pop()
        node_start[node] = s
        node_end[node] = e
        sel = order[s:e]
        node_min[node] = lo[sel].min(axis=0)
        node_max[node] = hi[sel].max(axis=0)
        if e - s <= leaf_size:
            left[node] = s
            count[node] = e - s
            continue

        c = centroid[sel]
        mid = None
        if method == "sah" and e - s > 2 * leaf_size:
            c_lo = c.min(axis=0)
            c_ext = c.max(axis=0) - c_lo
            axis = int(np.argmax(c_ext))
            if c_ext[axis] > 1e-12:
                t = (c[:, axis] - c_lo[axis]) / c_ext[axis]
                b = np.minimum((t * sah_bins).astype(np.int64), sah_bins - 1)
                cnt = np.bincount(b, minlength=sah_bins)
                bin_lo = np.full((sah_bins, 3), np.inf, np.float32)
                bin_hi = np.full((sah_bins, 3), -np.inf, np.float32)
                np.minimum.at(bin_lo, b, lo[sel])
                np.maximum.at(bin_hi, b, hi[sel])
                lft_lo = np.minimum.accumulate(bin_lo, axis=0)
                lft_hi = np.maximum.accumulate(bin_hi, axis=0)
                rgt_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
                rgt_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
                n_l = np.cumsum(cnt)[:-1]
                n_r = (e - s) - n_l
                cost = (half_area(lft_lo[:-1], lft_hi[:-1]) * n_l
                        + half_area(rgt_lo[1:], rgt_hi[1:]) * n_r)
                valid_split = (n_l > 0) & (n_r > 0)
                if valid_split.any():
                    cost = np.where(valid_split, cost, np.inf)
                    k = int(np.argmin(cost))
                    go_left = b <= k
                    part = np.argsort(~go_left, kind="stable")
                    order[s:e] = sel[part]
                    mid = int(go_left.sum())
        if mid is None:
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = (e - s) // 2
            part = np.argpartition(c[:, axis], mid)
            order[s:e] = sel[part]

        l_idx, r_idx = n_nodes, n_nodes + 1
        n_nodes += 2
        left[node] = l_idx
        right[node] = r_idx
        count[node] = 0
        stack.append((l_idx, s, s + mid))
        stack.append((r_idx, s + mid, e))

    return (node_min[:n_nodes], node_max[:n_nodes], left[:n_nodes], right[:n_nodes],
            count[:n_nodes], node_start[:n_nodes], node_end[:n_nodes], order)


def _derive_packed(node_min, node_max, left, right, count, blas_root, tri_v0, tri_e1, tri_e2):
    """Binary-tree records from tensors: children bounds in the parent
    (M, 12), ints [left, right, count, redirect] (M, 4), quad rows
    (S/4, 36)."""
    cap = node_min.shape[0] - 1
    li = torch.clamp(left, 0, cap).long()
    ri = torch.clamp(right, 0, cap).long()
    cbounds = torch.cat([node_min[li], node_max[li], node_min[ri], node_max[ri]], dim=-1)
    redirect = torch.where(count == -1,
                           blas_root[torch.clamp(left, 0, blas_root.shape[0] - 1).long()], 0)
    node_int = torch.stack([left, right, count, redirect], dim=-1).to(torch.int32)
    tri_quad = torch.cat([tri_v0, tri_e1, tri_e2], dim=-1).reshape(-1, 36)
    return cbounds, node_int, tri_quad


# Child descriptor (i32): desc >= 0 is an internal wide node; desc < 0 with
# e = -desc - 1 has kind e >> 28: 0 = quad leaf, payload (quad_row << 3) |
# tri_count; 1 = instance leaf, payload the instance slot.


def _wide_desc_leaf(left: int, cnt: int) -> int:
    return -(1 + (((left >> 2) << 3) | cnt))


def _wide_desc_inst(inst: int) -> int:
    return -(1 + ((1 << 28) | inst))


def _collapse_wide(node_min, node_max, left, right, count, roots):
    """Collapse binary trees (one root each) to 8-wide nodes: starting from
    a node's children, repeatedly replace the internal child of largest
    surface area by its two children until 8 slots are used. Returns
    (wide_meta (W, 8), wide_src (W, 8) binary node per slot or -1,
    {binary root: wide id})."""
    ext = np.maximum(node_max - node_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    metas: list[list[int]] = []
    srcs: list[list[int]] = []
    wide_root_of: dict[int, int] = {}
    queue: list[tuple[int, int]] = []  # (wide id, binary subtree root)

    def enqueue(b: int) -> int:
        wid = len(queue)
        queue.append((wid, b))
        return wid

    for root in roots:
        wide_root_of[int(root)] = enqueue(int(root))

    qi = 0
    while qi < len(queue):
        _wid, b = queue[qi]
        qi += 1
        ch = [b] if count[b] != 0 else [int(left[b]), int(right[b])]
        while len(ch) < WIDE_WIDTH:
            best, best_a = -1, -1.0
            for k, c in enumerate(ch):
                if count[c] == 0 and area[c] > best_a:
                    best, best_a = k, float(area[c])
            if best < 0:
                break
            c = ch.pop(best)
            ch.extend((int(left[c]), int(right[c])))
        meta_row = []
        src_row = []
        for c in ch:
            if count[c] == 0:
                meta_row.append(enqueue(c))
            elif count[c] > 0:
                meta_row.append(_wide_desc_leaf(int(left[c]), int(count[c])))
            else:
                meta_row.append(_wide_desc_inst(int(left[c])))
            src_row.append(c)
        while len(meta_row) < WIDE_WIDTH:
            meta_row.append(0)
            src_row.append(-1)
        metas.append(meta_row)
        srcs.append(src_row)

    return (np.asarray(metas, np.int32).reshape(-1, WIDE_WIDTH),
            np.asarray(srcs, np.int32).reshape(-1, WIDE_WIDTH), wide_root_of)


def _derive_wide_bounds(node_min, node_max, wide_src):
    """(W, 48) per-child [lo3, hi3] from tensors; empty slots get inverted
    bounds that no slab test hits."""
    src = torch.clamp(wide_src, min=0).long()
    empty = (wide_src < 0)[..., None]
    lo = torch.where(empty, 3e30, node_min[src])
    hi = torch.where(empty, -3e30, node_max[src])
    return torch.cat([lo, hi], dim=-1).reshape(-1, 6 * WIDE_WIDTH)


def _derive_wide_recs(wide_cbounds, wide_meta, tri_quad, tri_order, inst_w2o,
                      inst_tri_base, wide_root_blas):
    """The three traversal records as contiguous int32 rows (f32 lanes
    bit-cast), from tensors."""
    wide_rec = torch.cat([wide_cbounds.contiguous().view(torch.int32), wide_meta], -1)
    q = tri_quad.shape[0]
    ids = tri_order[: q * 4].reshape(q, 4).to(torch.int32)
    quad_rec = torch.cat([tri_quad.contiguous().view(torch.int32), ids], -1)
    n_i = inst_w2o.shape[0]
    w2o_flat = inst_w2o.reshape(n_i, 12).contiguous().view(torch.int32)
    zero = torch.zeros((1,), dtype=torch.int32, device=inst_w2o.device)
    base = torch.cat([zero, inst_tri_base.to(torch.int32)])
    root = torch.cat([zero, wide_root_blas.to(torch.int32)])
    inst_rec = torch.cat([w2o_flat, base[:, None], root[:, None]], -1)
    return wide_rec, quad_rec, inst_rec


def _affine_inverse_np(m: np.ndarray) -> np.ndarray:
    """(4, 4) -> (3, 4) inverse of an affine transform."""
    inv = np.linalg.inv(m.astype(np.float64))
    return inv[:3, :4].astype(np.float32)


def _align_leaves_quad(nodes, order):
    """Re-lay a built tree's slots so leaf k occupies [4k, 4k + 4), padding
    short leaves by duplicating their first primitive. Returns (node tuple,
    new order)."""
    node_min, node_max, left, right, count, node_start, node_end = nodes
    is_leaf = count > 0
    leaf_ids = np.nonzero(is_leaf)[0]
    rank = np.argsort(node_start[leaf_ids], kind="stable")
    leaf_ids = leaf_ids[rank]
    n_leaves = len(leaf_ids)
    starts = node_start[leaf_ids]
    counts = count[leaf_ids]

    new_order = np.zeros((4 * n_leaves,), order.dtype)
    for k in range(n_leaves):
        s0 = starts[k]
        c = counts[k]
        seg = order[s0:s0 + c]
        new_order[4 * k:4 * k + c] = seg
        new_order[4 * k + c:4 * k + 4] = seg[0]

    left = left.copy()
    node_start = node_start.copy()
    node_end = node_end.copy()
    left[leaf_ids] = 4 * np.arange(n_leaves)
    node_start[leaf_ids] = 4 * np.arange(n_leaves)
    node_end[leaf_ids] = 4 * np.arange(n_leaves) + 4
    internal = np.nonzero(~is_leaf)[0]
    if len(internal):
        first_rank = np.maximum(
            np.searchsorted(starts, node_start[internal], side="right") - 1, 0)
        last_rank = np.searchsorted(starts, node_end[internal] - 1, side="right") - 1
        node_start[internal] = 4 * first_rank
        node_end[internal] = 4 * (last_rank + 1)
    return (node_min, node_max, left, right, count, node_start, node_end), new_order


def build_two_level_host(
    blas_geo: list[tuple],
    inst_blas: np.ndarray,      # (I,) i32 BLAS id per instance
    inst_o2w: np.ndarray,       # (I, 4, 4) f32 object -> world
    inst_tri_base: np.ndarray,  # (I,) i32 global triangle id base per instance
    blas_owner: np.ndarray | None = None,  # (B,) owning instance of a deformable BLAS, else -1
    inst_id: np.ndarray | None = None,     # (I,) scene instance ids
    inst_cap: int | None = None,           # parked instance slots reserved up to this count
    meta_out: dict | None = None,
) -> dict[str, np.ndarray]:
    """The two-level build on the host: every TwoLevelBVH field as a numpy
    array (``n_tlas`` an int). ``blas_geo[b]`` is (verts (V, 3) object
    space, tris (t, 3)) or (verts, tris, tri_ids) where ``tri_ids`` maps
    each row of ``tris`` to the segment's original triangle. ``meta_out``,
    when a dict, receives what streaming wires a new instance with: the
    real and total instance slots (``n_real``, ``n_inst``) and each BLAS's
    root node and wide root (``roots_by_blas``, ``wide_root_of_blas``)."""
    n_inst = len(inst_blas)
    if n_inst == 0 or len(blas_geo) == 0:
        blas_geo = [(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32))]
        inst_blas = np.zeros((1,), np.int32)
        inst_o2w = np.eye(4, dtype=np.float32)[None]
        inst_tri_base = np.zeros((1,), np.int32)
        n_inst = 1
        blas_owner = None
        inst_id = None
    if blas_owner is None:
        blas_owner = np.full((len(blas_geo),), -1, np.int32)
    if inst_id is None or len(inst_id) != n_inst:
        inst_id = np.arange(n_inst, dtype=np.int32)

    # Parked instance slots: distinct tiny boxes far below the scene.
    n_real = n_inst
    if inst_cap is not None and inst_cap > n_inst:
        pad = inst_cap - n_inst
        inst_blas = np.concatenate([np.asarray(inst_blas, np.int32), np.zeros(pad, np.int32)])
        park = np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))
        park[:, 0, 3] = -1e9 + np.arange(pad, dtype=np.float32)
        park[:, 1, 3] = -1e9
        park[:, 2, 3] = -1e9
        inst_o2w = np.concatenate([np.asarray(inst_o2w, np.float32), park])
        inst_tri_base = np.concatenate([np.asarray(inst_tri_base, np.int32),
                                        np.zeros(pad, np.int32)])
        inst_id = np.concatenate([np.asarray(inst_id, np.int32), np.zeros(pad, np.int32)])
        n_inst = inst_cap
    inst_active = np.arange(n_inst) < n_real

    # Per-BLAS builds in object space.
    blas_nodes = []
    blas_slots = []  # (local tri order, v0, e1, e2, owner)
    for b, geo in enumerate(blas_geo):
        verts, tris = geo[0], geo[1]
        tri_ids = geo[2] if len(geo) > 2 else None
        v = verts[tris]
        nodes = _median_build(v.min(axis=1), v.max(axis=1), LEAF_SIZE)
        packed, order = _align_leaves_quad(nodes[:-1], nodes[-1].astype(np.int32))
        tv = v[order]
        local_ids = order if tri_ids is None else np.asarray(tri_ids, np.int32)[order]
        blas_nodes.append(packed)
        blas_slots.append((local_ids, tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0],
                           np.full((len(order),), blas_owner[b], np.int32)))

    # TLAS over instance world AABBs (leaf size 1).
    root_lo = np.stack([n[0][0] for n in blas_nodes])
    root_hi = np.stack([n[1][0] for n in blas_nodes])
    c_obj = 0.5 * (root_lo + root_hi)[inst_blas]
    e_obj = 0.5 * (root_hi - root_lo)[inst_blas]
    rot = inst_o2w[:, :3, :3]
    wc = np.einsum("iab,ib->ia", rot, c_obj) + inst_o2w[:, :3, 3]
    we = np.einsum("iab,ib->ia", np.abs(rot), e_obj)
    (t_min, t_max_, t_left, t_right, t_count, t_start, t_end,
     t_order) = _median_build(wc - we, wc + we, 1)
    n_tlas = t_min.shape[0]
    leaf = t_count > 0
    t_left = np.where(leaf, t_order.astype(np.int32)[np.clip(t_start, 0, n_inst - 1)], t_left)
    t_count = np.where(leaf, -1, t_count)

    # BLAS node and slot pools packed after the TLAS.
    node_off = n_tlas
    slot_off = 0
    roots_by_blas = np.zeros((len(blas_geo),), np.int32)
    packed_nodes = [(t_min, t_max_, t_left, t_right, t_count, t_start, t_end)]
    for b, (nm, nx, lf, rt, ct, ns, ne) in enumerate(blas_nodes):
        roots_by_blas[b] = node_off
        internal = ct == 0
        lf = np.where(internal, lf + node_off, lf + slot_off)
        rt = np.where(internal, rt + node_off, rt)
        packed_nodes.append((nm, nx, lf, rt, ct, ns + slot_off, ne + slot_off))
        node_off += nm.shape[0]
        slot_off += blas_slots[b][0].shape[0]
    cat = [np.concatenate([p[i] for p in packed_nodes]) for i in range(7)]
    node_min, node_max, left, right, count, node_start, node_end = cat

    w2o = np.stack([np.eye(3, 4, dtype=np.float32)]
                   + [_affine_inverse_np(inst_o2w[i]) for i in range(n_inst)])
    nm = node_min.astype(np.float32)
    nx = node_max.astype(np.float32)
    lf = left.astype(np.int32)
    rt = right.astype(np.int32)
    ct = count.astype(np.int32)
    v0 = np.concatenate([s[1] for s in blas_slots]).astype(np.float32)
    e1 = np.concatenate([s[2] for s in blas_slots]).astype(np.float32)
    e2 = np.concatenate([s[3] for s in blas_slots]).astype(np.float32)
    br = roots_by_blas[inst_blas].astype(np.int32)
    w_meta, w_src, w_root_of = _collapse_wide(
        node_min, node_max, left, right, count, [0] + [int(r) for r in roots_by_blas])
    wide_root_of_blas = np.asarray([w_root_of[int(r)] for r in roots_by_blas], np.int32)
    w_root_blas = wide_root_of_blas[inst_blas]
    if meta_out is not None:
        meta_out.update(n_real=n_real, n_inst=n_inst, roots_by_blas=roots_by_blas.copy(),
                        wide_root_of_blas=wide_root_of_blas)
    tri_order = np.concatenate([s[0] for s in blas_slots])
    itb = inst_tri_base.astype(np.int32)
    # The records through the refit's torch derivations, on CPU tensors.
    def tt(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    packed = _derive_packed(*map(tt, (nm, nx, lf, rt, ct, br, v0, e1, e2)))
    w_cb = _derive_wide_bounds(tt(nm), tt(nx), tt(w_src))
    recs = _derive_wide_recs(w_cb, tt(w_meta), packed[2], tt(tri_order), tt(w2o), tt(itb),
                             tt(w_root_blas))
    cbounds, node_int, tri_quad = (x.numpy() for x in packed)
    w_cb = w_cb.numpy()
    w_rec, q_rec, i_rec = (x.numpy() for x in recs)
    return dict(
        node_min=nm, node_max=nx, left=lf, right=rt, count=ct,
        node_start=node_start.astype(np.int32), node_end=node_end.astype(np.int32),
        tri_order=tri_order, tri_v0=v0, tri_e1=e1, tri_e2=e2,
        slot_inst=np.concatenate([s[4] for s in blas_slots]),
        inst_order=t_order.astype(np.int32), inst_w2o=w2o,
        inst_o2w=inst_o2w[:, :3, :4].astype(np.float32), blas_root=br, inst_tri_base=itb,
        inst_id=np.asarray(inst_id, np.int32), node_cbounds=cbounds, node_int=node_int,
        tri_quad=tri_quad, wide_meta=w_meta, wide_src=w_src, wide_cbounds=w_cb,
        wide_root_blas=w_root_blas, wide_rec=w_rec, quad_rec=q_rec, inst_rec=i_rec,
        inst_active=inst_active, n_tlas=n_tlas,
    )


def build_two_level(*args, device="cuda", **kw) -> TwoLevelBVH:
    """``build_two_level_host`` moved to ``device`` once."""
    return bvh_from_host(build_two_level_host(*args, **kw), device)


def build_bvh(world_verts: np.ndarray, tris: np.ndarray, tri_valid: np.ndarray,
              device="cuda") -> FlatBVH:
    """The flat BVH over the valid triangles of ``tris`` (T, 3) into
    ``world_verts`` (V, 3), built on the host and moved to ``device`` once;
    no valid triangle leaves one leaf over triangle 0."""
    ids = np.nonzero(tri_valid)[0].astype(np.int32)
    if len(ids) == 0:
        ids = np.zeros((1,), np.int32)
    v = world_verts[tris[ids]]
    (node_min, node_max, left, right, count, node_start, node_end,
     order) = _median_build(v.min(axis=1), v.max(axis=1), LEAF_SIZE)
    tri_order = ids[order]
    tv = world_verts[tris[tri_order]]
    return bvh_from_host(dict(
        node_min=node_min, node_max=node_max, left=left, right=right, count=count,
        node_start=node_start, node_end=node_end, tri_order=tri_order,
        tri_v0=tv[:, 0].astype(np.float32), tri_e1=(tv[:, 1] - tv[:, 0]).astype(np.float32),
        tri_e2=(tv[:, 2] - tv[:, 0]).astype(np.float32)), device)


# ---------------------------------------------------------------------------
# Refit (torch, on the BVH's device)


def _rmq_bounds(lo: torch.Tensor, hi: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor):
    """Sparse-table range min/max: the AABB union of each range [start, end)
    of the (n, 3) bounds, for all ranges at once (1 <= end - start <= n).
    Level k holds the union over [i, i + 2^k); a range reads two entries of
    level floor(log2(length)), with that level computed in float32 as the
    reference computes it."""
    n = lo.shape[0]
    levels = max(int(np.ceil(np.log2(max(n, 1)))) + 1, 1)
    pw_lo, pw_hi = [lo], [hi]
    for k in range(1, levels):
        half = 1 << (k - 1)
        a, b = pw_lo[-1], pw_hi[-1]
        pw_lo.append(torch.cat([torch.minimum(a[:n - half], a[half:]), a[n - half:]]))
        pw_hi.append(torch.cat([torch.maximum(b[:n - half], b[half:]), b[n - half:]]))
    table_lo = torch.stack(pw_lo)
    table_hi = torch.stack(pw_hi)
    length = (ends - starts).to(torch.float32)
    k = torch.floor(torch.log2(torch.clamp(length, min=1.0)) + 1e-6).to(torch.int64)
    second = ends.to(torch.int64) - torch.bitwise_left_shift(torch.ones_like(k), k)
    s = starts.to(torch.int64)
    q_min = torch.minimum(table_lo[k, s], table_lo[k, second])
    q_max = torch.maximum(table_hi[k, s], table_hi[k, second])
    return q_min, q_max


def _affine_inverse(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) affine -> (..., 3, 4) inverse, through the 3x3 adjugate."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    c0 = torch.cross(r[..., :, 1], r[..., :, 2], dim=-1)
    c1 = torch.cross(r[..., :, 2], r[..., :, 0], dim=-1)
    c2 = torch.cross(r[..., :, 0], r[..., :, 1], dim=-1)
    det = torch.sum(r[..., :, 0] * c0, dim=-1, keepdim=True)[..., None]
    inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det, 0.0)
    r_inv = torch.stack([c0, c1, c2], dim=-2) * inv_det
    t_inv = -torch.einsum("...ab,...b->...a", r_inv, t)
    return torch.cat([r_inv, t_inv[..., None]], dim=-1)


def _rotate(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(I, 3, 3) m times (I, 3) v as ((m0 v0 + m1 v1) + m2 v2)."""
    return m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2] + m[:, :, 2] * v[:, 2:3]


def refit_bvh(bvh: TwoLevelBVH | FlatBVH, world_verts: torch.Tensor, tris: torch.Tensor,
              world: torch.Tensor | None = None) -> TwoLevelBVH | FlatBVH:
    """The BVH with the same topology and new bounds, on the device.

    A FlatBVH re-reads every slot's triangle from ``world_verts`` (V, 3)
    through ``tris`` (Tmax, 3) and takes each node's bounds as the range
    min/max over its slots (``world`` unused). A TwoLevelBVH:

    1. the slots of deformable (per-instance) BLASes re-read their triangles
       from ``world_verts`` (V, 3) through ``tris`` (Tmax, 3), the pool's
       indices; shared static slots keep their object-space triangles;
    2. BLAS node bounds are range min/max over their slots (``_rmq_bounds``:
       the build keeps each node's slots contiguous);
    3. with ``world`` ((>= I, 4, 4) the scene's instance transforms), the
       instance transforms and their inverses are refreshed;
    4. the instances' world boxes (parked slots stay parked) and the TLAS
       bounds follow, then the traversal records are re-derived (the wide
       ones only where the BVH has them)."""
    if isinstance(bvh, FlatBVH):
        v = world_verts[tris[bvh.tri_order.long()].long()]  # (T, 3, 3) in slot order
        node_min, node_max = _rmq_bounds(v.amin(1), v.amax(1), bvh.node_start, bvh.node_end)
        return bvh._replace(node_min=node_min, node_max=node_max, tri_v0=v[:, 0],
                            tri_e1=v[:, 1] - v[:, 0], tri_e2=v[:, 2] - v[:, 0])
    own_i = torch.clamp(bvh.slot_inst, min=0).long()
    gid = torch.clamp(bvh.inst_tri_base[own_i] + bvh.tri_order, 0, tris.shape[0] - 1).long()
    v = world_verts[tris[gid].long()]                       # (T, 3, 3)
    own = (bvh.slot_inst >= 0)[:, None]
    v0 = torch.where(own, v[:, 0], bvh.tri_v0)
    e1 = torch.where(own, v[:, 1] - v[:, 0], bvh.tri_e1)
    e2 = torch.where(own, v[:, 2] - v[:, 0], bvh.tri_e2)
    v1 = v0 + e1
    v2 = v0 + e2
    lo = torch.minimum(v0, torch.minimum(v1, v2))
    hi = torch.maximum(v0, torch.maximum(v1, v2))
    nt = bvh.n_tlas
    b_min, b_max = _rmq_bounds(lo, hi, bvh.node_start[nt:], bvh.node_end[nt:])

    if world is not None:
        o2w = world[bvh.inst_id.long()][..., :3, :4]
        eye = torch.eye(3, 4, dtype=torch.float32, device=o2w.device)[None]
        w2o = torch.cat([eye, _affine_inverse(o2w)])
    else:
        o2w, w2o = bvh.inst_o2w, bvh.inst_w2o

    root = (bvh.blas_root - nt).long()
    r_lo, r_hi = b_min[root], b_max[root]
    c = 0.5 * (r_lo + r_hi)
    e = 0.5 * (r_hi - r_lo)
    rot = o2w[:, :3, :3]
    wc = _rotate(rot, c) + o2w[:, :3, 3]
    we = _rotate(torch.abs(rot), e)
    if bvh.inst_active is not None:
        act = bvh.inst_active[:, None]
        wc = torch.where(act, wc, -1e9)
        we = torch.where(act, we, 0.0)
    order = bvh.inst_order.long()
    t_min, t_max = _rmq_bounds((wc - we)[order], (wc + we)[order], bvh.node_start[:nt],
                               bvh.node_end[:nt])

    node_min = torch.cat([t_min, b_min])
    node_max = torch.cat([t_max, b_max])
    cbounds, node_int, tri_quad = _derive_packed(node_min, node_max, bvh.left, bvh.right,
                                                 bvh.count, bvh.blas_root, v0, e1, e2)
    wide_cb = wide_rec = quad_rec = inst_rec = None
    if bvh.wide_src is not None:
        wide_cb = _derive_wide_bounds(node_min, node_max, bvh.wide_src)
        wide_rec, quad_rec, inst_rec = _derive_wide_recs(
            wide_cb, bvh.wide_meta, tri_quad, bvh.tri_order, w2o, bvh.inst_tri_base,
            bvh.wide_root_blas)
    return dataclasses.replace(
        bvh, node_min=node_min, node_max=node_max, tri_v0=v0, tri_e1=e1, tri_e2=e2,
        inst_o2w=o2w, inst_w2o=w2o, node_cbounds=cbounds, node_int=node_int,
        tri_quad=tri_quad, wide_cbounds=wide_cb, wide_rec=wide_rec, quad_rec=quad_rec,
        inst_rec=inst_rec)


def refit_bvh_in_place(bvh: TwoLevelBVH | FlatBVH, world_verts: torch.Tensor,
                       tris: torch.Tensor) -> None:
    """``refit_bvh`` (without new instance transforms) written back into
    ``bvh``'s own tensors, which keep their storage: how a streamed
    instance's rows join the live TLAS and traversal records."""
    new = refit_bvh(bvh, world_verts, tris)
    for f in FlatBVH._fields if isinstance(bvh, FlatBVH) else ARRAY_FIELDS:
        old_t, new_t = getattr(bvh, f), getattr(new, f)
        if new_t is not None and new_t is not old_t:
            old_t.copy_(new_t)


# ---------------------------------------------------------------------------
# Traversal: the plain torch version of csrc/bvh_trace.cu


def _dot3(ax, ay, az, bx, by, bz):
    """a . b as ((ax bx + ay by) + az bz), the kernel's order."""
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _apply34(m, px, py, pz, translate: bool):
    """Rows of the (n, 12) w2o lanes applied to (px, py, pz): the kernel's
    ((m0 x + m1 y) + m2 z) + (m3 or 0)."""
    out = []
    for a in range(3):
        r = m[:, 4 * a + 0] * px + m[:, 4 * a + 1] * py + m[:, 4 * a + 2] * pz
        out.append(r + (m[:, 4 * a + 3] if translate else 0.0))
    return out


def _inv_dir(d):
    return 1.0 / torch.where(torch.abs(d) < DIR_EPS,
                             torch.where(d < 0, -DIR_EPS, DIR_EPS), d)


def _min3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def _max3(a, b, c):
    return torch.maximum(torch.maximum(a, b), c)


def _tri_hit(v0, e1, e2, o, d, t_eps):
    """Moller-Trumbore, the kernel's arithmetic: returns (ok, t, u, v)."""
    px_, py_, pz_ = _cross3(*d, *e2)
    det = _dot3(*e1, px_, py_, pz_)
    good = torch.abs(det) > DIR_EPS
    inv_det = torch.where(good, 1.0 / det, 0.0)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = _dot3(tx, ty, tz, px_, py_, pz_) * inv_det
    qx, qy, qz = _cross3(tx, ty, tz, *e1)
    v = _dot3(*d, qx, qy, qz) * inv_det
    t = _dot3(*e2, qx, qy, qz) * inv_det
    ok = good & (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= ONE_PLUS_EPS) & (t > t_eps)
    return ok, t, u, v


class _Rays:
    """The per-ray state of a lockstep walk, kept compact: ``live`` holds
    each per-ray tensor for the rays still walking only (``ids`` their
    rows), so a step touches no stopped ray. A ray that stops writes its
    ``out`` fields (the result tensors, full length) once, when it is
    retired."""

    def __init__(self, out: dict, state: dict):
        self.out = out
        self.live = {**{k: v.clone() for k, v in out.items()}, **state}
        self.ids = torch.arange(next(iter(out.values())).shape[0], device=state["sp"].device)

    def walking(self) -> bool:
        """Retire the rays whose stack is empty; False once none walks."""
        keep = self.live["sp"] > 0
        if not bool(keep.all()):
            self.retire(keep)
        return self.ids.numel() > 0

    def retire(self, keep: torch.Tensor | None = None) -> None:
        """Write the results of the rays not in ``keep`` (all of them when
        None) and drop them from the working set."""
        if keep is None:
            keep = torch.zeros_like(self.ids, dtype=torch.bool)
        gone = ~keep
        rows = self.ids[gone]
        for k, v in self.out.items():
            v[rows] = self.live[k][gone]
        self.live = {k: v[keep] for k, v in self.live.items()}
        self.ids = self.ids[keep]


def _walk_start(origins, directions, t_max, extra_out=(), depth: int = STACK_DEPTH,
                **state) -> _Rays:
    """The walks' per-ray state: an empty stack of ``depth`` entries with
    the root pushed (sp 1), the rays, any further ``state``, and the results
    so far (t = t_max, no triangle, and each ``extra_out`` count 0)."""
    dev, r = origins.device, origins.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    out = dict(t=torch.broadcast_to(tm, (r,)).clone(), tri=torch.full((r,), -1, **i32),
               u=torch.zeros((r,), dtype=torch.float32, device=dev),
               v=torch.zeros((r,), dtype=torch.float32, device=dev),
               **{k: torch.zeros((r,), **i32) for k in extra_out})
    live = dict(stack=torch.zeros((r, depth), **i32), sp=torch.ones((r,), **i32),
                o=origins, d=directions)
    return _Rays(out, {**live, **state})


def _hit_of(rays: _Rays) -> Hit:
    rays.retire()
    out = rays.out
    return Hit(t=out["t"], tri=out["tri"], u=out["u"], v=out["v"], hit=out["tri"] >= 0)


_STAT_KEYS = ("steps", "quad_steps", "node_steps", "triangle_tests", "inst_steps")


def trace_wide_plain(bvh: TwoLevelBVH, origins: torch.Tensor, directions: torch.Tensor,
                     t_max=1e30, t_eps: float = 1e-4, any_hit: bool = False,
                     max_steps: int = 512, stats: dict | None = None) -> Hit:
    """The 8-wide two-level walk in torch ops, with the reference's per-ray
    semantics (``_trace_wide``): each ray pops one stack entry a step until
    its stack is empty or the step count reaches ``max_steps``; an instance
    leaf switches the ray to the instance's object space and processes its
    BLAS root in the same step; a quad leaf tests its four triangles; an
    internal node slab-tests its 8 children and pushes the hit ones, the
    nearest on top (Batcher's 8-sort; any-hit skips the sort and stops on
    the first accepted hit). Pushes past the 64-entry stack are dropped.

    Each step works only on the rays still walking (``_Rays``), which
    changes no ray's result. When ``stats`` is a dict it receives per-ray
    counts of steps, quad steps, node steps, triangle tests and ray
    transforms (``steps``, ``quad_steps``, ``node_steps``,
    ``triangle_tests``, ``inst_steps``: the TLAS entry at the ray's first
    step, and one per instance entered), for a bound on the work."""
    dev = origins.device
    r = origins.shape[0]
    f_rec = bvh.wide_rec.view(torch.float32)
    q_rec = bvh.quad_rec
    q_f = q_rec.view(torch.float32)
    i_rec = bvh.inst_rec
    i_f = i_rec.view(torch.float32)
    q_cap = q_rec.shape[0] - 1
    depth = WIDE_STACK_DEPTH
    i32 = dict(dtype=torch.int32, device=dev)
    rays = _walk_start(origins, directions, t_max, _STAT_KEYS if stats is not None else (),
                       depth=depth, ci=torch.full((r,), -1, **i32), bsp=torch.zeros((r,), **i32))

    quad_lanes = torch.arange(4, **i32)
    for _ in range(max_steps):
        if not rays.walking():
            break
        live = rays.live
        n = rays.ids.numel()
        lane = torch.arange(n, device=dev)
        st, s, ci, bsp = live["stack"], live["sp"], live["ci"], live["bsp"]
        bt, btri, bu, bv = live["t"], live["tri"], live["u"], live["v"]

        top = s - 1
        desc = st[lane, top.long()]
        left_blas = top < bsp
        ci = torch.where(left_blas, -1, ci)
        bsp = torch.where(left_blas, 0, bsp)
        sp_pop = s - 1
        e = -desc - 1
        kind = e >> 28
        payload = e & 0x0FFFFFFF
        is_quad = (desc < 0) & (kind == 0)
        is_inst = (desc < 0) & (kind == 1)
        is_node = (desc >= 0) | is_inst
        ci = torch.where(is_inst, payload, ci)
        bsp = torch.where(is_inst, sp_pop, bsp)

        # Instance record (row 0 = identity for the TLAS).
        irow = (ci + 1).long()
        mm = i_f[irow, :12]
        g_base = i_rec[irow, 12]
        node = torch.where(is_inst, i_rec[irow, 13], torch.where(desc >= 0, desc, 0))
        org, dr = live["o"], live["d"]
        o = _apply34(mm, org[:, 0], org[:, 1], org[:, 2], True)
        d = _apply34(mm, dr[:, 0], dr[:, 1], dr[:, 2], False)
        inv_d = [_inv_dir(c) for c in d]

        # Quad leaf: its 4 triangles at once; the first of the nearest
        # accepted ones wins, as testing them in order with a strict ``<``.
        # Each part runs on its own rays only (a quad ray pushes nothing, a
        # node ray tests no triangle), which changes no ray's result.
        qcount = payload & 7
        qi = torch.nonzero(is_quad).squeeze(1)
        if qi.numel():
            qrow = torch.clamp(payload[qi] >> 3, 0, q_cap).long()
            quad = q_f[qrow, :36].view(-1, 4, 9)
            o4 = [c[qi, None] for c in o]
            d4 = [c[qi, None] for c in d]
            ok, t, u, v = _tri_hit([quad[..., j] for j in range(0, 3)],
                                   [quad[..., j] for j in range(3, 6)],
                                   [quad[..., j] for j in range(6, 9)], o4, d4, t_eps)
            cand = (quad_lanes < qcount[qi, None]) & ok
            t_cand = torch.where(cand, t, math.inf)
            t_min = t_cand.amin(1)
            k1 = torch.where(t_cand == t_min[:, None], quad_lanes, 4).amin(1, keepdim=True).long()
            q_bt = bt[qi]
            take = t_min < q_bt
            bt = bt.index_put((qi,), torch.where(take, t_min, q_bt))
            btri = btri.index_put((qi,), torch.where(
                take, g_base[qi] + q_rec[qrow, 36:40].gather(1, k1)[:, 0], btri[qi]))
            bu = bu.index_put((qi,), torch.where(take, u.gather(1, k1)[:, 0], bu[qi]))
            bv = bv.index_put((qi,), torch.where(take, v.gather(1, k1)[:, 0], bv[qi]))

        # Internal node: its 8 slab tests at once, the sort, the push.
        new_sp = sp_pop
        ni = torch.nonzero(is_node).squeeze(1)
        if ni.numel():
            m = ni.numel()
            nrow = node[ni].long()
            cb = f_rec[nrow, :48].view(m, WIDE_WIDTH, 6)
            meta = bvh.wide_rec[nrow, 48:56]
            o8 = torch.stack([c[ni] for c in o], dim=-1)[:, None, :]
            inv8 = torch.stack([c[ni] for c in inv_d], dim=-1)[:, None, :]
            t0 = (cb[..., 0:3] - o8) * inv8
            t1 = (cb[..., 3:6] - o8) * inv8
            tlo, thi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = _max3(tlo[..., 0], tlo[..., 1], tlo[..., 2])
            near = torch.maximum(near, torch.zeros_like(near))
            far = torch.minimum(_min3(thi[..., 0], thi[..., 1], thi[..., 2]), bt[ni, None])
            hit_c = (near <= far) & (meta != 0)
            keys = list(torch.where(hit_c, near, NO_KEY).unbind(1))
            descs = list(meta.unbind(1))
            if not any_hit:
                for a, b in SORT_NET:
                    swap = keys[a] > keys[b]
                    keys[a], keys[b] = torch.where(swap, keys[b], keys[a]), torch.where(swap, keys[a], keys[b])
                    descs[a], descs[b] = torch.where(swap, descs[b], descs[a]), torch.where(swap, descs[a], descs[b])
            # Children pushed farthest first: the nearest ends on top.
            valid = torch.stack(keys, dim=1) < NO_KEY
            above = valid.flip(1).cumsum(1, dtype=torch.int32).flip(1) - valid.to(torch.int32)
            pos = sp_pop[ni, None] + above
            put = valid & (pos < depth)
            st[ni[:, None].expand(m, WIDE_WIDTH)[put], pos[put].long()] = \
                torch.stack(descs, dim=1)[put]
            cnt = valid.sum(1, dtype=torch.int32)
            new_sp = new_sp.index_put((ni,), torch.clamp(sp_pop[ni] + cnt, max=depth - 1))
        if any_hit:
            new_sp = torch.where(btri >= 0, 0, new_sp)

        live.update(sp=new_sp, ci=ci, bsp=bsp, t=bt, tri=btri, u=bu, v=bv)
        if stats is not None:
            first = (live["steps"] == 0).to(torch.int32)
            live.update(inst_steps=live["inst_steps"] + first + is_inst.to(torch.int32),
                        steps=live["steps"] + 1,
                        quad_steps=live["quad_steps"] + is_quad.to(torch.int32),
                        node_steps=live["node_steps"] + is_node.to(torch.int32),
                        triangle_tests=live["triangle_tests"] + torch.where(is_quad, qcount, 0))
    hit = _hit_of(rays)
    if stats is not None:
        stats.update({k: rays.out[k] for k in _STAT_KEYS})
    return hit


def _aabb_hit(lo, hi, o, inv_d, t_max):
    """The reference's slab test of (n, 3) boxes against (n, 3) rays:
    (hit, t_near), t_near clamped at 0 and the far end at ``t_max``."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = torch.minimum(t0, t1).amax(-1)
    near = torch.maximum(near, torch.zeros_like(near))
    far = torch.minimum(torch.maximum(t0, t1).amin(-1), t_max)
    return near <= far, near


def _push(st, lane, sp, ok, value, depth: int):
    """Push ``value`` where ``ok`` at ``min(sp, depth - 1)`` (a full stack
    overwrites its top entry, as the reference's clamped scatter does);
    returns the new stack pointers."""
    slot = torch.clamp(sp, max=depth - 1).long()
    st[lane, slot] = torch.where(ok, value, st[lane, slot])
    return torch.where(ok, torch.clamp(sp + 1, max=depth - 1), sp)


def trace_flat_plain(bvh: FlatBVH, origins: torch.Tensor, directions: torch.Tensor,
                     t_max=1e30, t_eps: float = 1e-4, any_hit: bool = False,
                     max_steps: int = 512) -> Hit:
    """The reference's flat lockstep walk (``trace_rays`` on a FlatBVH) in
    torch ops: each step every ray pops one node, slab-tests it against its
    best hit so far, tests a leaf's triangles in slot order (strict ``<``:
    the first of equal hits wins) or pushes an internal node's hit children,
    the far one first (the near one on top, the left where they tie). Pushes
    past the 48-entry stack overwrite its top. Any-hit stops a ray at its
    first accepted hit; ``max_steps`` cuts every ray after that many steps.
    Each step works only on the rays still walking, which changes no ray's
    result."""
    rays = _walk_start(origins, directions, t_max, inv=_inv_dir(directions))
    n_cap = bvh.node_min.shape[0] - 1
    s_cap = bvh.tri_v0.shape[0] - 1
    for _ in range(max_steps):
        if not rays.walking():
            break
        live = rays.live
        lane = torch.arange(rays.ids.numel(), device=origins.device)
        st, s, o, d, inv = live["stack"], live["sp"], live["o"], live["d"], live["inv"]
        bt, btri, bu, bv = live["t"], live["tri"], live["u"], live["v"]

        node = st[lane, (s - 1).long()].long()
        hit_box = _aabb_hit(bvh.node_min[node], bvh.node_max[node], o, inv, bt)[0]
        cnt = bvh.count[node]
        left = bvh.left[node]
        right = bvh.right[node]
        do_leaf = hit_box & (cnt > 0)
        oc, dc = o.unbind(1), d.unbind(1)
        for k in range(LEAF_SIZE):
            slot = torch.clamp(left + k, 0, s_cap).long()
            ok, t, u, v = _tri_hit(bvh.tri_v0[slot].unbind(1), bvh.tri_e1[slot].unbind(1),
                                   bvh.tri_e2[slot].unbind(1), oc, dc, t_eps)
            take = do_leaf & (k < cnt) & ok & (t < bt)
            bt = torch.where(take, t, bt)
            btri = torch.where(take, bvh.tri_order[slot], btri)
            bu = torch.where(take, u, bu)
            bv = torch.where(take, v, bv)

        do_int = hit_box & (cnt <= 0)
        lc = torch.clamp(left, 0, n_cap).long()
        rc = torch.clamp(right, 0, n_cap).long()
        hit_l, near_l = _aabb_hit(bvh.node_min[lc], bvh.node_max[lc], o, inv, bt)
        hit_r, near_r = _aabb_hit(bvh.node_min[rc], bvh.node_max[rc], o, inv, bt)
        l_first = near_l <= near_r
        new_sp = _push(st, lane, s - 1, torch.where(l_first, hit_r, hit_l) & do_int,
                       torch.where(l_first, right, left), STACK_DEPTH)
        new_sp = _push(st, lane, new_sp, torch.where(l_first, hit_l, hit_r) & do_int,
                       torch.where(l_first, left, right), STACK_DEPTH)
        if any_hit:
            new_sp = torch.where(btri >= 0, 0, new_sp)
        live.update(sp=new_sp, t=bt, tri=btri, u=bu, v=bv)
    return _hit_of(rays)


def _trace_two_level_plain(bvh: TwoLevelBVH, origins: torch.Tensor, directions: torch.Tensor,
                           t_max=1e30, t_eps: float = 1e-4, any_hit: bool = False,
                           max_steps: int = 512) -> Hit:
    """The reference's binary two-level walk (``_trace_two_level``) in
    torch ops, over the packed binary records: each step a ray pops one node
    in its current instance's space (row 0 of ``inst_w2o``, the identity, in
    the TLAS); an internal node slab-tests both children from its own
    ``node_cbounds`` row and pushes the hit ones, the far one first; a
    triangle leaf tests its quad row's triangles in order; an instance leaf
    pushes its BLAS root and enters the instance, remembering the stack
    depth at entry (``base_sp``): popping below it returns the ray to the
    TLAS. Directions are not renormalised, so ``t`` is in world units at both
    levels. Stack overflow, any-hit and ``max_steps`` as in
    ``trace_flat_plain``."""
    dev, r = origins.device, origins.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    rays = _walk_start(origins, directions, t_max, ci=torch.full((r,), -1, **i32),
                       bsp=torch.zeros((r,), **i32))
    w2o = bvh.inst_w2o.reshape(-1, 12)
    q_cap = bvh.tri_quad.shape[0] - 1
    s_cap = bvh.tri_order.shape[0] - 1
    for _ in range(max_steps):
        if not rays.walking():
            break
        live = rays.live
        lane = torch.arange(rays.ids.numel(), device=dev)
        st, s, ci, bsp = live["stack"], live["sp"], live["ci"], live["bsp"]
        bt, btri, bu, bv = live["t"], live["tri"], live["u"], live["v"]

        top = s - 1
        node = st[lane, top.long()].long()
        left_blas = top < bsp
        ci = torch.where(left_blas, -1, ci)
        bsp = torch.where(left_blas, 0, bsp)
        mm = w2o[(ci + 1).long()]
        org, dr = live["o"], live["d"]
        o = _apply34(mm, org[:, 0], org[:, 1], org[:, 2], True)
        d = _apply34(mm, dr[:, 0], dr[:, 1], dr[:, 2], False)
        o3 = torch.stack(o, dim=-1)
        inv3 = torch.stack([_inv_dir(c) for c in d], dim=-1)

        n_left, n_right, cnt, redirect = bvh.node_int[node].unbind(1)
        cb = bvh.node_cbounds[node]
        is_internal = cnt == 0
        hit_l, near_l = _aabb_hit(cb[:, 0:3], cb[:, 3:6], o3, inv3, bt)
        hit_r, near_r = _aabb_hit(cb[:, 6:9], cb[:, 9:12], o3, inv3, bt)
        hit_l = hit_l & is_internal
        hit_r = hit_r & is_internal

        do_leaf = cnt > 0
        quad = bvh.tri_quad[torch.clamp(n_left >> 2, 0, q_cap).long()]
        g_base = bvh.inst_tri_base[torch.clamp(ci, min=0).long()]
        for k in range(LEAF_SIZE):
            ok, t, u, v = _tri_hit(quad[:, 9 * k:9 * k + 3].unbind(1),
                                   quad[:, 9 * k + 3:9 * k + 6].unbind(1),
                                   quad[:, 9 * k + 6:9 * k + 9].unbind(1), o, d, t_eps)
            take = do_leaf & (k < cnt) & ok & (t < bt)
            slot = torch.clamp(n_left + k, 0, s_cap).long()
            bt = torch.where(take, t, bt)
            btri = torch.where(take, g_base + bvh.tri_order[slot], btri)
            bu = torch.where(take, u, bu)
            bv = torch.where(take, v, bv)

        l_first = near_l <= near_r
        do_inst = cnt < 0
        new_sp = _push(st, lane, s - 1, torch.where(l_first, hit_r, hit_l),
                       torch.where(l_first, n_right, n_left), STACK_DEPTH)
        push2 = torch.where(l_first, hit_l, hit_r) | do_inst
        after = _push(st, lane, new_sp, push2,
                      torch.where(do_inst, redirect, torch.where(l_first, n_left, n_right)),
                      STACK_DEPTH)
        # Entering a BLAS: the instance, and the depth of its pushed root.
        ci = torch.where(do_inst, n_left, ci)
        bsp = torch.where(do_inst, new_sp, bsp)
        if any_hit:
            after = torch.where(btri >= 0, 0, after)
        live.update(sp=after, ci=ci, bsp=bsp, t=bt, tri=btri, u=bu, v=bv)
    return _hit_of(rays)


def trace_rays(bvh: TwoLevelBVH | FlatBVH, origins: torch.Tensor, directions: torch.Tensor,
               t_max=1e30, t_eps: float = 1e-4, any_hit: bool = False, max_steps: int = 512,
               chunk_size: int | None = None, label: str | None = None) -> Hit:
    """Closest-hit (or any-hit) traversal of (R, 3) rays; directions need
    not be normalised (``t`` is in their units). ``t_max`` is a float or a
    tensor broadcastable to (R,).

    The walk follows the BVH, as the reference's dispatch does: a FlatBVH
    (a scene built without a BVH carries a one-leaf placeholder, which every
    ray misses) takes ``trace_flat_plain``, a TwoLevelBVH without wide
    records ``_trace_two_level_plain``, and any other the 8-wide walk: on
    CUDA tensors the hand-written kernel (``ops/bvh_cuda.trace_rays_cuda``),
    on CPU tensors ``trace_wide_plain``. ``label`` names the trace in the
    kernel's launch counts (``trace_rays_cuda.launches_by_label``).

    ``chunk_size`` traces the rays in sequential chunks of that many, which
    bounds the walks' per-ray state to one chunk at a time; a per-ray
    ``t_max`` goes along with its chunk (a broadcastable one is first made
    per ray), a scalar to every chunk."""
    r_total = origins.shape[0]
    kw = dict(t_eps=t_eps, any_hit=any_hit, max_steps=max_steps, label=label)
    if chunk_size is not None and r_total > chunk_size:
        if isinstance(t_max, torch.Tensor) and t_max.ndim > 0 and t_max.shape != (r_total,):
            t_max = torch.broadcast_to(t_max, (r_total,))
        per_ray = isinstance(t_max, torch.Tensor) and t_max.ndim > 0
        parts = [trace_rays(bvh, origins[s:s + chunk_size], directions[s:s + chunk_size],
                            t_max=t_max[s:s + chunk_size] if per_ray else t_max, **kw)
                 for s in range(0, r_total, chunk_size)]
        return Hit(*(torch.cat(x) for x in zip(*parts)))
    if isinstance(bvh, FlatBVH):
        return trace_flat_plain(bvh, origins, directions, t_max=t_max, t_eps=t_eps,
                                any_hit=any_hit, max_steps=max_steps)
    if bvh.wide_meta is None:
        return _trace_two_level_plain(bvh, origins, directions, t_max=t_max, t_eps=t_eps,
                                      any_hit=any_hit, max_steps=max_steps)
    if origins.device.type == "cuda":
        from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda

        return trace_rays_cuda(bvh, origins, directions, t_max=t_max, **kw)
    return trace_wide_plain(bvh, origins, directions, t_max=t_max, t_eps=t_eps,
                            any_hit=any_hit, max_steps=max_steps)


def trace_rays_brute(world_verts: np.ndarray, tris: np.ndarray, tri_valid: np.ndarray,
                     origins: np.ndarray, directions: np.ndarray, t_max: float = 1e30,
                     t_eps: float = 1e-4):
    """The reference's numpy oracle, O(R x T): every valid triangle against
    every ray (Moller-Trumbore without slack). Returns (t (R,) f32, t_max on
    a miss; tri (R,) i32, -1 on a miss)."""
    r = origins.shape[0]
    best_t = np.full((r,), t_max, np.float32)
    best_tri = np.full((r,), -1, np.int32)
    for ti in np.nonzero(tri_valid)[0]:
        v0, v1, v2 = world_verts[tris[ti]]
        e1 = v1 - v0
        e2 = v2 - v0
        pvec = np.cross(directions, e2)
        det = (e1[None] * pvec).sum(-1)
        good = np.abs(det) > 1e-12
        inv = np.where(good, 1.0 / np.where(det == 0, 1, det), 0.0)
        tvec = origins - v0
        u = (tvec * pvec).sum(-1) * inv
        qvec = np.cross(tvec, e1)
        v = (directions * qvec).sum(-1) * inv
        t = (e2[None] * qvec).sum(-1) * inv
        ok = good & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_eps) & (t < best_t)
        best_t[ok] = t[ok]
        best_tri[ok] = ti
    return best_t, best_tri
