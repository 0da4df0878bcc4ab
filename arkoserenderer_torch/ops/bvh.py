"""Two-level BVH: the host build and the 8-wide traversal (port of
arkoserenderer_tpu/ops/bvh.py, the two-level build and ``_trace_wide``).

The build runs on the host in numpy, as the reference's does, and every
array it makes equals the reference build's (ints equal, floats and the
bit-cast record rows bit for bit); ``build_two_level`` then moves the
arrays to the device once. One BLAS per unique geometry in object space,
binned-SAH binary trees with 4-aligned quad leaves, a TLAS over the
instances' world AABBs, and the whole pool collapsed to branching factor 8
(``_collapse_wide``). Traversal reads three packed int32 record rows a
step (``wide_rec``, ``quad_rec``, ``inst_rec``; floats travel bit-cast).

``refit_bvh`` is the per-frame refit of an animated scene, on the device:
the same topology with new bounds, the deformable BLASes' triangles re-read
from the deformed vertex pool, the instance transforms and the TLAS from the
scene's world matrices, and the three records re-derived. The record
derivations (``_derive_packed``, ``_derive_wide_bounds``,
``_derive_wide_recs``) are torch functions that the host build calls too, so
the layout has one source.

``trace_rays`` runs the 8-wide two-level walk: the hand-written CUDA
kernel (``ops/bvh_cuda.trace_rays_cuda``) for CUDA tensors, its plain torch
version ``trace_wide_plain`` for CPU tensors. The flat single-level walk and
the binary two-level walk of the reference (the path tracer's and
``bake_ao``'s) are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

LEAF_SIZE = 4
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
    (row 0 the identity)."""

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
    wide_meta: torch.Tensor
    wide_src: torch.Tensor
    wide_cbounds: torch.Tensor
    wide_root_blas: torch.Tensor
    wide_rec: torch.Tensor
    quad_rec: torch.Tensor
    inst_rec: torch.Tensor
    inst_active: torch.Tensor
    n_tlas: int = 1


ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(TwoLevelBVH) if f.name != "n_tlas")


def bvh_from_host(fields: dict, device) -> TwoLevelBVH:
    """A TwoLevelBVH on ``device`` from host arrays keyed by field name
    (copies; ``n_tlas`` as an int or a 0-d array)."""
    arrays = {k: torch.from_numpy(np.array(fields[k], copy=True)).to(device)
              for k in ARRAY_FIELDS}
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


def refit_bvh(bvh: TwoLevelBVH, world_verts: torch.Tensor, tris: torch.Tensor,
              world: torch.Tensor | None = None) -> TwoLevelBVH:
    """The BVH with the same topology and new bounds, on the device:

    1. the slots of deformable (per-instance) BLASes re-read their triangles
       from ``world_verts`` (V, 3) through ``tris`` (Tmax, 3), the pool's
       indices; shared static slots keep their object-space triangles;
    2. BLAS node bounds are range min/max over their slots (``_rmq_bounds``:
       the build keeps each node's slots contiguous);
    3. with ``world`` ((>= I, 4, 4) the scene's instance transforms), the
       instance transforms and their inverses are refreshed;
    4. the instances' world boxes (parked slots stay parked) and the TLAS
       bounds follow, then the three traversal records are re-derived."""
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
    wide_cb = _derive_wide_bounds(node_min, node_max, bvh.wide_src)
    wide_rec, quad_rec, inst_rec = _derive_wide_recs(
        wide_cb, bvh.wide_meta, tri_quad, bvh.tri_order, w2o, bvh.inst_tri_base,
        bvh.wide_root_blas)
    return dataclasses.replace(
        bvh, node_min=node_min, node_max=node_max, tri_v0=v0, tri_e1=e1, tri_e2=e2,
        inst_o2w=o2w, inst_w2o=w2o, node_cbounds=cbounds, node_int=node_int,
        tri_quad=tri_quad, wide_cbounds=wide_cb, wide_rec=wide_rec, quad_rec=quad_rec,
        inst_rec=inst_rec)


def refit_bvh_in_place(bvh: TwoLevelBVH, world_verts: torch.Tensor,
                       tris: torch.Tensor) -> None:
    """``refit_bvh`` (without new instance transforms) written back into
    ``bvh``'s own tensors, which keep their storage: how a streamed
    instance's rows join the live TLAS and traversal records."""
    new = refit_bvh(bvh, world_verts, tris)
    for f in ARRAY_FIELDS:
        old_t, new_t = getattr(bvh, f), getattr(new, f)
        if new_t is not old_t:
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

    Each step works only on the rays still walking, which changes no ray's
    result. When ``stats`` is a dict it receives per-ray counts of steps,
    quad steps, node steps, triangle tests and ray transforms (``steps``,
    ``quad_steps``, ``node_steps``, ``triangle_tests``, ``inst_steps``: the
    TLAS entry at the ray's first step, and one per instance entered), for a
    bound on the work."""
    dev = origins.device
    r = origins.shape[0]
    f_rec = bvh.wide_rec.view(torch.float32)
    q_rec = bvh.quad_rec
    q_f = q_rec.view(torch.float32)
    i_rec = bvh.inst_rec
    i_f = i_rec.view(torch.float32)
    q_cap = q_rec.shape[0] - 1
    depth = WIDE_STACK_DEPTH

    stack = torch.zeros((r, depth), dtype=torch.int32, device=dev)
    sp = torch.ones((r,), dtype=torch.int32, device=dev)
    cur_inst = torch.full((r,), -1, dtype=torch.int32, device=dev)
    base_sp = torch.zeros((r,), dtype=torch.int32, device=dev)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    best_t = torch.broadcast_to(tm, (r,)).clone()
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((r,), dtype=torch.float32, device=dev)
    counts = None
    if stats is not None:
        counts = {k: torch.zeros((r,), dtype=torch.int32, device=dev)
                  for k in ("steps", "quad_steps", "node_steps", "triangle_tests",
                            "inst_steps")}

    quad_lanes = torch.arange(4, dtype=torch.int32, device=dev)
    for _ in range(max_steps):
        rows = torch.nonzero(sp > 0).squeeze(1)
        if rows.numel() == 0:
            break
        n = rows.numel()
        lane = torch.arange(n, device=dev)
        st = stack[rows]
        s = sp[rows]
        ci = cur_inst[rows]
        bsp = base_sp[rows]
        bt, btri, bu, bv = best_t[rows], best_tri[rows], best_u[rows], best_v[rows]

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
        org, dr = origins[rows], directions[rows]
        o = _apply34(mm, org[:, 0], org[:, 1], org[:, 2], True)
        d = _apply34(mm, dr[:, 0], dr[:, 1], dr[:, 2], False)
        inv_d = [_inv_dir(c) for c in d]

        # Quad leaf: its 4 triangles at once; the first of the nearest
        # accepted ones wins, as testing them in order with a strict ``<``.
        qrow = torch.clamp(payload >> 3, 0, q_cap).long()
        qcount = payload & 7
        quad = q_f[qrow, :36].view(n, 4, 9)
        o4 = [c[:, None] for c in o]
        d4 = [c[:, None] for c in d]
        ok, t, u, v = _tri_hit([quad[..., j] for j in range(0, 3)],
                               [quad[..., j] for j in range(3, 6)],
                               [quad[..., j] for j in range(6, 9)], o4, d4, t_eps)
        cand = is_quad[:, None] & (quad_lanes < qcount[:, None]) & ok
        t_cand = torch.where(cand, t, math.inf)
        t_min = t_cand.amin(1)
        k1 = torch.where(t_cand == t_min[:, None], quad_lanes, 4).amin(1, keepdim=True).long()
        take = t_min < bt
        bt = torch.where(take, t_min, bt)
        btri = torch.where(take, g_base + q_rec[qrow, 36:40].gather(1, k1)[:, 0], btri)
        bu = torch.where(take, u.gather(1, k1)[:, 0], bu)
        bv = torch.where(take, v.gather(1, k1)[:, 0], bv)

        # Internal node: its 8 slab tests at once, the sort, the push.
        nrow = node.long()
        cb = f_rec[nrow, :48].view(n, WIDE_WIDTH, 6)
        meta = bvh.wide_rec[nrow, 48:56]
        o8 = torch.stack(o, dim=-1)[:, None, :]
        inv8 = torch.stack(inv_d, dim=-1)[:, None, :]
        t0 = (cb[..., 0:3] - o8) * inv8
        t1 = (cb[..., 3:6] - o8) * inv8
        tlo, thi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = _max3(tlo[..., 0], tlo[..., 1], tlo[..., 2])
        near = torch.maximum(near, torch.zeros_like(near))
        far = torch.minimum(_min3(thi[..., 0], thi[..., 1], thi[..., 2]), bt[:, None])
        hit_c = (near <= far) & is_node[:, None] & (meta != 0)
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
        pos = sp_pop[:, None] + above
        put = valid & (pos < depth)
        st[lane[:, None].expand(n, WIDE_WIDTH)[put], pos[put].long()] = \
            torch.stack(descs, dim=1)[put]
        cnt = valid.sum(1, dtype=torch.int32)
        new_sp = torch.clamp(sp_pop + cnt, max=depth - 1)
        if any_hit:
            new_sp = torch.where(btri >= 0, 0, new_sp)

        stack[rows] = st
        sp[rows] = new_sp
        cur_inst[rows] = ci
        base_sp[rows] = bsp
        best_t[rows], best_tri[rows], best_u[rows], best_v[rows] = bt, btri, bu, bv
        if counts is not None:
            first = (counts["steps"][rows] == 0).to(torch.int32)
            counts["inst_steps"][rows] += first + is_inst.to(torch.int32)
            counts["steps"][rows] += 1
            counts["quad_steps"][rows] += is_quad.to(torch.int32)
            counts["node_steps"][rows] += is_node.to(torch.int32)
            counts["triangle_tests"][rows] += torch.where(is_quad, qcount, 0)
    if counts is not None:
        stats.update(counts)
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v, hit=best_tri >= 0)


def trace_rays(bvh: TwoLevelBVH | None, origins: torch.Tensor, directions: torch.Tensor,
               t_max=1e30, t_eps: float = 1e-4, any_hit: bool = False, max_steps: int = 512,
               label: str | None = None) -> Hit:
    """Closest-hit (or any-hit) traversal of (R, 3) rays; directions need
    not be normalised (``t`` is in their units). ``t_max`` is a float or a
    tensor broadcastable to (R,). On CUDA tensors the hand-written kernel
    runs (``ops/bvh_cuda.trace_rays_cuda``), on CPU tensors
    ``trace_wide_plain``. ``label`` names the trace in the kernel's launch
    counts (``trace_rays_cuda.launches_by_label``). ``bvh`` is None for a
    scene built without one, which raises."""
    if bvh is None:
        raise ValueError("the scene has no BVH: build it with_bvh=True to trace rays")
    if origins.device.type == "cuda":
        from arkoserenderer_torch.ops.bvh_cuda import trace_rays_cuda

        return trace_rays_cuda(bvh, origins, directions, t_max=t_max, t_eps=t_eps,
                               any_hit=any_hit, max_steps=max_steps, label=label)
    return trace_wide_plain(bvh, origins, directions, t_max=t_max, t_eps=t_eps,
                            any_hit=any_hit, max_steps=max_steps)
