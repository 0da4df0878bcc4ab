"""Measurements of the BVH traversal kernel (csrc/bvh_trace.cu) on the card.

Helpers used by chip_smoke.py and the tests: the rays of one frame's traces
captured as the frame makes them, with the BVH each trace walked (the
frame's refitted one on an animated scene; ``capture_traces``), random rays
through a
4,096-instance TLAS (``tlas_case``), DDGI-shaped probe rays through the
``rt`` scene (``probe_case``), hand-made records that overflow the stack
(``overflow_case``) and edge rays (``edge_cases``: ray counts that are no
multiple of a group or a block, zero and negative-zero direction
components, negative-zero origins, t_max of inf and 0, origins inside
instance boxes); the kernel held bit for bit against its plain torch
version with the per-ray counts the plain walk reports (``compare``), the
kernel's bound from those counts (``bound_ms``), and its times: the
wrapper's (CUDA events around back-to-back ``trace_rays_cuda`` calls, as
the frame calls it), the device's (a CUDA graph of launches through the C
entry point into outputs made once) and the plain version's.

Run as a script it does all of that for the five traces of one 1920x1080
``rt`` frame (sun mask, spot mask, reflection, and the sun and spot
occlusion rays at the reflection hits), the TLAS case, the probe case, and
the four DDGI traces of one 1920x1080 ``flagship`` frame (``ddgi_traces``:
262,144 probe rays, closest-hit, then the sun's and the two casting
spots' any-hit occlusion rays at their hits, captured as the frame makes
them):

    python -m arkoserenderer_torch.tools.trace_bench

With ``--other OLD_CHECKOUT`` (a root that holds ``arkoserenderer_torch/``)
it compares the other checkout's kernel with this one on those twelve
traces: both built from their own ``csrc/`` (the other into its own
``build/``, under its own library name), held equal bit for bit, then timed
in turns (other, this, this, other) per round, device ms by CUDA graphs;
it prints the medians:

    python -m arkoserenderer_torch.tools.trace_bench --other OLD_CHECKOUT

Prints the card line, one line per case, and one JSON line. Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from arkoserenderer_torch.core.halton import fibonacci_sphere
from arkoserenderer_torch.ops import bvh as bvh_ops
from arkoserenderer_torch.ops import bvh_cuda
from arkoserenderer_torch.ops.raster_cuda import build_kernels, ptxas_report
from arkoserenderer_torch.rendering.pipeline import eager_frames
from arkoserenderer_torch.tools.raster_bench import (
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    card_line,
    events_ms,
    graph_ms,
    load_wrapper,
)

# FP32 operations of the kernel (csrc/bvh_trace.cu), counted from its
# source, each mul, add, min, max, compare and division as one: a ray
# transform costs 42 (18 mul/add for the origin, 18 for the direction, 3
# guarded divisions), made once a ray for the TLAS and once per instance
# the ray enters (the plain walk's ``inst_steps``); each triangle a quad step
# tests costs 53 (two cross products, four dot products, the division, the
# barycentric and t comparisons); a node step slab-tests 8 children at 25
# each, and a closest-hit node step sorts them with 19 compare-exchanges
# (any-hit skips the sort). The rate they are held to, FP32_OPS_PER_S, is
# the card's published FP32 peak, which counts a fused multiply-add as two
# operations; the kernel is built with --fmad=false, so each counted
# operation is an instruction of its own and the card executes them at no
# more than half that rate: the operations bound is optimistic by up to 2x.
OPS_TRANSFORM = 42
OPS_TRIANGLE = 53
OPS_SLAB = 8 * 25
OPS_SORT = 19
WRAPPER_CALLS = 20  # back-to-back wrapper calls under CUDA events
TLAS_INSTANCES = 4096
TLAS_RAYS = 1 << 20
# The probe case: the flagship's DDGI trace (1,024 probes x 256 rays), the
# probes the first of a 16x8x16 grid over the scene's box shrunk by 10 %.
PROBE_GRID = (16, 8, 16)
PROBES, PROBE_RAYS, PROBE_SEED, PROBE_T_MAX = 1024, 256, 7, 1e4
EDGE_COUNTS = (0, 1, 33, 4099)  # no multiple of a group (8 lanes) or a block
OVERFLOW_STEPS = (9, 20, 512)
AB_ROUNDS = 3  # rounds of (other, this, this, other) in the A/B


def capture_traces(renderer) -> list[dict]:
    """Render one frame of ``renderer`` and return the inputs of each trace
    it makes, in order: {label, bvh, origins, directions, t_max (a float or
    a per-ray tensor), any_hit}, the rays as copies on the card, ``bvh`` the
    one the trace walked."""
    return capture_calls(renderer.render_frame)


@contextlib.contextmanager
def plain_traces():
    """Within it, ``ops/bvh.trace_rays`` on CUDA tensors walks with
    ``trace_wide_plain`` instead of the kernel (nothing is counted): the
    plain side of a comparison made through a caller of the traversal.
    Frames run eagerly within it (``eager_frames``)."""
    kernel = bvh_cuda.trace_rays_cuda

    def plain(bvh, origins, directions, label=None, **kw):
        return bvh_ops.trace_wide_plain(bvh, origins, directions, **kw)

    bvh_cuda.trace_rays_cuda = plain
    try:
        with eager_frames():
            yield
    finally:
        bvh_cuda.trace_rays_cuda = kernel


def capture_calls(fn) -> list[dict]:
    """Call ``fn()`` and return the inputs of each trace it makes, as
    ``capture_traces`` does for a frame (a path tracer's sample: ``lambda:
    tracer.render_sample(1)``). Frames run eagerly within it
    (``eager_frames``: a replay calls no wrapper)."""
    captured = []
    kernel = bvh_cuda.trace_rays_cuda

    def record(bvh, origins, directions, t_max=1e30, any_hit=False, label=None, **kw):
        tm = t_max.clone() if isinstance(t_max, torch.Tensor) else t_max
        captured.append(dict(label=label, bvh=bvh, origins=origins.clone(),
                             directions=directions.clone(), t_max=tm, any_hit=any_hit))
        return kernel(bvh, origins, directions, t_max=t_max, any_hit=any_hit, label=label, **kw)

    record.launches = kernel.launches
    record.launches_by_label = kernel.launches_by_label
    bvh_cuda.trace_rays_cuda = record
    try:
        with eager_frames():
            fn()
    finally:
        bvh_cuda.trace_rays_cuda = kernel
    torch.cuda.synchronize()
    return captured


def tlas_case(device, n_inst: int = TLAS_INSTANCES, n_rays: int = TLAS_RAYS, seed: int = 5):
    """A two-level BVH of ``n_inst`` instances (two small random meshes on a
    jittered 16^3 grid, rotated about y, plus 64 parked slots) and random
    rays through its bounds, from a numpy seed: (bvh, origins, directions,
    per-ray t_max)."""
    rng = np.random.default_rng(seed)

    def mesh(n):
        c = rng.uniform(-0.3, 0.3, (n, 3))
        v = (c[:, None] + rng.normal(size=(n, 3, 3)) * 0.12).reshape(-1, 3).astype(np.float32)
        return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)

    blas = [mesh(48), mesh(32)]
    inst_blas = rng.integers(0, 2, n_inst).astype(np.int32)
    g = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3)[:n_inst]
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_inst, 1, 1))
    o2w[:, :3, 3] = (g - 7.5) + rng.uniform(-0.2, 0.2, (n_inst, 3))
    ang = rng.uniform(0, 2 * np.pi, n_inst)
    o2w[:, 0, 0], o2w[:, 0, 2] = np.cos(ang), np.sin(ang)
    o2w[:, 2, 0], o2w[:, 2, 2] = -np.sin(ang), np.cos(ang)
    base = np.concatenate([[0], np.cumsum([len(blas[b][1]) for b in inst_blas])[:-1]])
    bvh = bvh_ops.build_two_level(blas, inst_blas, o2w, base.astype(np.int32),
                                  inst_cap=n_inst + 64, device=device)
    origins = rng.uniform(-10, 10, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    t_max = rng.uniform(0.5, 30.0, n_rays).astype(np.float32)
    return bvh, *(torch.from_numpy(a).to(device) for a in (origins, dirs, t_max))


def overflow_case(device, levels: int = 12, n_rays: int = 512, seed: int = 11):
    """Hand-made wide records that overflow the 64-entry stack: node i of a
    chain of ``levels`` holds the next node (a box around the ray origins,
    key 0, so it is popped first) and 7 quad leaves along +x, one triangle
    each (the plane x = 100 - i - 0.1 j, nearer the deeper the level). Each
    level pushes 8 and pops 1, so at the ninth level the pushes pass index
    63: the next node and the nearest leaf are dropped, sp is capped at 63
    and the entry at index 63 is never read; which triangle a ray hits
    shows it. Returns (bvh, origins, directions) of rays along +x."""
    rng = np.random.default_rng(seed)
    n_quads = 7 * levels
    quad = np.zeros((n_quads, 40), np.float32)
    wide = np.zeros((levels, 48), np.float32)
    meta = np.zeros((levels, 8), np.int32)
    for i in range(levels):
        wide[i, 0:6] = (-1.0, -2.0, -2.0, 1000.0, 2.0, 2.0)
        meta[i, 0] = i + 1 if i + 1 < levels else 0
        for j in range(1, 8):
            row = 7 * i + (j - 1)
            x = 100.0 - i - 0.1 * j
            quad[row, 0:9] = (x, -0.5, -0.5, 0.0, 2.0, 0.0, 0.0, 0.0, 2.0)
            wide[i, 6 * j:6 * j + 6] = (x - 0.01, -0.5, -0.5, x + 0.01, 1.5, 1.5)
            meta[i, j] = bvh_ops._wide_desc_leaf(4 * row, 1)
    quad_rec = quad.view(np.int32).copy()
    quad_rec[:, 36] = np.arange(n_quads)
    host = dict(wide_rec=np.concatenate([wide.view(np.int32), meta], -1),
                quad_rec=quad_rec, inst_rec=np.concatenate(
                    [np.eye(3, 4, dtype=np.float32).reshape(1, 12).view(np.int32),
                     np.zeros((1, 2), np.int32)], -1))
    small = bvh_ops.build_two_level_host([(np.eye(3, dtype=np.float32),
                                           np.array([[0, 1, 2]], np.int32))],
                                         np.zeros(1, np.int32), np.eye(4, dtype=np.float32)[None],
                                         np.zeros(1, np.int32))
    bvh = bvh_ops.bvh_from_host({**small, **host}, device)
    origins = np.zeros((n_rays, 3), np.float32)
    origins[:, 1:] = rng.uniform(-0.3, 0.3, (n_rays, 2))
    dirs = np.zeros((n_rays, 3), np.float32)
    dirs[:, 0] = 1.0
    dirs[:, 1:] = rng.normal(size=(n_rays, 2)) * 1e-4
    return bvh, *(torch.from_numpy(a).to(device) for a in (origins, dirs))


def probe_case(scene, device):
    """DDGI-shaped probe rays through ``scene`` (the host Scene): the first
    PROBES points of a PROBE_GRID grid spanning the scene's bounding box
    shrunk by 10 % about its centre, each casting the PROBE_RAYS directions
    of ``fibonacci_sphere`` rotated by one unit quaternion (w, x, y, z)
    drawn from ``numpy.random.default_rng(PROBE_SEED)``: (origins,
    directions) of PROBES * PROBE_RAYS rays, probe-major."""
    mins, maxs = scene.bounding_box()
    centre, half = 0.5 * (mins + maxs), 0.45 * (maxs - mins)
    axes = [np.linspace(centre[a] - half[a], centre[a] + half[a], n)
            for a, n in enumerate(PROBE_GRID)]
    probes = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)[:PROBES]
    w, x, y, z = (lambda q: q / np.linalg.norm(q))(
        np.random.default_rng(PROBE_SEED).normal(size=4))
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    dirs = fibonacci_sphere(PROBE_RAYS).astype(np.float64) @ rot.T
    origins = np.repeat(probes, PROBE_RAYS, axis=0).astype(np.float32)
    directions = np.tile(dirs, (PROBES, 1)).astype(np.float32)
    return (torch.from_numpy(origins).to(device), torch.from_numpy(directions).to(device))


def edge_cases(device, seed: int = 13) -> list[dict]:
    """Edge rays through a 64-instance TLAS, closest-hit and any-hit, for
    each ray count of EDGE_COUNTS (the first n of one set of 4,099 rays,
    with per-ray t_max), and all 4,099 with a scalar t_max of inf. Two rays
    in three start inside an instance's box; direction components are
    exactly 0 or -0.0 in four rays of five (one, two or all three of them,
    or an axis-aligned unit ray), origin components -0.0 in two rays of
    seven; t_max is inf in one ray of four and 0 in another. Returns
    [{label, bvh, origins, directions, t_max, any_hit}]."""
    bvh = tlas_case(device, n_inst=64, n_rays=1, seed=seed)[0]
    rng = np.random.default_rng(seed)
    n = max(EDGE_COUNTS)
    i = np.arange(n)
    centres = bvh.inst_o2w[:64, :, 3].cpu().numpy()
    origins = centres[i % 64] + rng.uniform(-0.2, 0.2, (n, 3))
    outside = i % 3 == 2
    origins[outside] = rng.uniform(centres.min(0) - 2.0, centres.max(0) + 2.0,
                                   (int(outside.sum()), 3))
    origins = origins.astype(np.float32)
    origins[i % 7 == 0, 0] = -0.0
    origins[i % 7 == 1, 1:] = -0.0
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[i % 5 == 0, 0] = 0.0
    dirs[i % 5 == 1, 1:] = (-0.0, 0.0)
    dirs[i % 5 == 2] = (0.0, -0.0, 0.0)
    axis = np.zeros((n, 3), np.float32)
    axis[i, i % 3] = np.where(i % 2 == 0, 1.0, -1.0)
    axis[(i % 3 != 0) & (i % 2 == 1), 0] = -0.0
    dirs[i % 5 == 3] = axis[i % 5 == 3]
    t_max = rng.uniform(0.5, 20.0, n).astype(np.float32)
    t_max[i % 4 == 0] = np.inf
    t_max[i % 4 == 1] = 0.0
    o, d, tm = (torch.from_numpy(a).to(device) for a in (origins, dirs, t_max))
    cases = []
    for any_hit in (False, True):
        mode = "any-hit" if any_hit else "closest"
        for k in EDGE_COUNTS:
            cases.append(dict(label=f"edge {k} rays {mode}, per-ray t_max", bvh=bvh,
                              origins=o[:k], directions=d[:k], t_max=tm[:k], any_hit=any_hit))
        cases.append(dict(label=f"edge {n} rays {mode}, t_max inf", bvh=bvh, origins=o,
                          directions=d, t_max=float("inf"), any_hit=any_hit))
    return cases


def compare(bvh, origins, directions, t_max, any_hit: bool, label: str,
            max_steps: int = 512) -> dict:
    """The kernel against ``trace_wide_plain`` on the same rays: raises
    unless t, tri, u, v and hit are equal bit for bit; returns the hit
    share and the plain walk's counts (summed, and the worst ray's steps)."""
    hk = bvh_cuda.trace_rays_cuda(bvh, origins, directions, t_max=t_max, any_hit=any_hit,
                                  max_steps=max_steps)
    stats: dict = {}
    hp = bvh_ops.trace_wide_plain(bvh, origins, directions, t_max=t_max, any_hit=any_hit,
                                  max_steps=max_steps, stats=stats)
    torch.cuda.synchronize()
    assert_equal_bits(hk, hp, label, origins.shape[0])
    n = origins.shape[0]
    return {"rays": n, "hit_share": hk.hit.float().mean().item() if n else 0.0,
            "steps": int(stats["steps"].sum()),
            "max_steps": int(stats["steps"].max()) if n else 0,
            "node_steps": int(stats["node_steps"].sum()),
            "triangle_tests": int(stats["triangle_tests"].sum()),
            "inst_steps": int(stats["inst_steps"].sum()), "max_abs_err": 0.0}


def assert_equal_bits(a, b, label: str, n: int) -> None:
    """Raise unless the two Hits are equal bit for bit in every field."""
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: kernel != reference in {k} on "
                                 f"{int((x != y).sum())} of {n} rays")


def bound_ms(bvh, n_rays: int, per_ray_t_max: bool, any_hit: bool,
             counts: dict) -> tuple[float, str]:
    """The least time the card could take for one trace: the larger of the
    bytes it must move (each ray's origin, direction and t_max read once,
    t, tri, u and v written once, and the three record pools read once) over
    the HBM rate, and the operations the plain walk's counts imply over the
    float32 rate: a transform per ray and per instance entry
    (``inst_steps``), the triangle tests, and the node steps' slab tests
    and, closest-hit, sorts (``OPS_*``)."""
    rec_bytes = sum(getattr(bvh, k).numel() * 4 for k in bvh_cuda.RECORD_WIDTHS)
    nbytes = n_rays * (24 + (4 if per_ray_t_max else 0) + 16) + rec_bytes
    ops = (counts["inst_steps"] * OPS_TRANSFORM + counts["triangle_tests"] * OPS_TRIANGLE
           + counts["node_steps"] * (OPS_SLAB + (0 if any_hit else OPS_SORT)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def launcher(lib):
    """``fn(bvh, origins, directions, t_ray, t_max_all, any_hit, outs)``: one
    launch of ``lib``'s traversal into ``outs`` (t, tri, u, v, counter) on
    the current stream, through ``bvh_cuda.launch_raw``; for a library whose
    entry point takes no ray counter (an older checkout's) the same call
    without it."""
    if len(lib.bvh_trace_launch.argtypes) == 18:
        return lambda bvh, o, d, t_ray, tm, any_hit, outs: bvh_cuda.launch_raw(
            lib, bvh, o, d, t_ray, tm, 1e-4, any_hit, 512, *outs)

    def old(bvh, o, d, t_ray, tm, any_hit, outs):
        err = lib.bvh_trace_launch(
            bvh.wide_rec.data_ptr(), bvh.quad_rec.data_ptr(), bvh.inst_rec.data_ptr(),
            o.data_ptr(), d.data_ptr(), None if t_ray is None else t_ray.data_ptr(),
            float(tm), 1e-4, 512, int(any_hit), o.shape[0], bvh.quad_rec.shape[0],
            *(x.data_ptr() for x in outs[:4]), torch.cuda.current_stream(o.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bvh_trace_launch failed: CUDA error {err}")

    return old


def device_run(lib, bvh, origins, directions, t_max, any_hit: bool):
    """(launch, outs): a no-argument launch of ``lib``'s kernel on these
    rays into outputs made once (t, tri, u, v and the ray counter)."""
    r = origins.shape[0]
    dev = origins.device
    t_ray = (torch.broadcast_to(t_max, (r,)).contiguous()
             if isinstance(t_max, torch.Tensor) else None)
    outs = [torch.empty((r,), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    outs.append(torch.empty((1,), dtype=torch.int32, device=dev))
    scalar = 1e30 if t_ray is not None else float(t_max)
    fn = launcher(lib)
    return (lambda: fn(bvh, origins, directions, t_ray, scalar, any_hit, outs)), outs


def hit_of(outs) -> bvh_ops.Hit:
    """The Hit that ``device_run``'s outputs hold."""
    return bvh_ops.Hit(t=outs[0], tri=outs[1], u=outs[2], v=outs[3], hit=outs[1] >= 0)


def time_trace(bvh, origins, directions, t_max, any_hit: bool) -> dict:
    """Wrapper ms (CUDA events around back-to-back calls), device ms (a
    CUDA graph of launches through the C entry point) and plain ms."""
    ms = events_ms(lambda: bvh_cuda.trace_rays_cuda(bvh, origins, directions, t_max=t_max,
                                                    any_hit=any_hit), WRAPPER_CALLS)
    launch, _ = device_run(build_kernels(), bvh, origins, directions, t_max, any_hit)
    device_ms = graph_ms(launch)
    plain_ms = events_ms(lambda: bvh_ops.trace_wide_plain(bvh, origins, directions, t_max=t_max,
                                                          any_hit=any_hit), 1)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms}


def checked(bvh, case: dict) -> dict:
    """compare + bound of one captured or built trace."""
    args = (bvh, case["origins"], case["directions"], case["t_max"], case["any_hit"])
    res = {"name": case["label"], "trace": case.get("trace", case["label"]),
           "any_hit": case["any_hit"],
           "per_ray_t_max": isinstance(case["t_max"], torch.Tensor)}
    res.update(compare(*args, case["label"]))
    res["bound_ms"], res["bound_by"] = bound_ms(bvh, res["rays"], res["per_ray_t_max"],
                                                res["any_hit"], res)
    return res


def measure(bvh, case: dict) -> dict:
    """compare + bound + times of one captured or built trace."""
    res = checked(bvh, case)
    res.update(time_trace(bvh, case["origins"], case["directions"], case["t_max"],
                          case["any_hit"]))
    res["share"] = res["bound_ms"] / res["device_ms"]
    return res


def frame_traces(renderer) -> list[dict]:
    """The traces of one frame of ``renderer`` after a warm-up frame."""
    renderer.render_frame()
    return capture_traces(renderer)


def frame_cases(renderer) -> list[dict]:
    """Every trace of one frame of ``renderer`` (after a warm-up frame),
    measured."""
    return [measure(case["bvh"], case) for case in frame_traces(renderer)]


def kind_traces(renderer, kind: str, prefix: str = "") -> list[dict]:
    """The traces of one frame of ``renderer`` whose label starts with
    ``prefix``, as the frame makes them, each named "<kind> <label>";
    "trace" keeps the frame's label."""
    cases = [c for c in capture_traces(renderer) if c["label"].startswith(prefix)]
    for c in cases:
        c["trace"] = c["label"]
        c["label"] = f"{kind} {c['label']}"
    return cases


def kind_cases(renderer, kind: str, prefix: str = "") -> list[dict]:
    """``kind_traces``, measured."""
    return [measure(case["bvh"], case) for case in kind_traces(renderer, kind, prefix)]


def ddgi_traces(renderer) -> list[dict]:
    """The DDGI traces of one ``flagship`` frame of ``renderer`` (after a
    warm-up frame): "flagship ddgi probe", "flagship ddgi sun", ..."""
    renderer.render_frame()
    return kind_traces(renderer, "flagship", "ddgi")


def ddgi_cases(renderer) -> list[dict]:
    """The DDGI traces of one flagship frame, measured."""
    return [measure(case["bvh"], case) for case in ddgi_traces(renderer)]


def tlas_traces(device) -> tuple:
    """(bvh, cases) of the closest-hit and any-hit (per-ray t_max) random
    rays through the 4,096-instance TLAS."""
    bvh, o, d, tm = tlas_case(device)
    return bvh, [dict(label=f"tlas{TLAS_INSTANCES} closest", origins=o, directions=d,
                      t_max=1e30, any_hit=False),
                 dict(label=f"tlas{TLAS_INSTANCES} any-hit t_max", origins=o, directions=d,
                      t_max=tm, any_hit=True)]


def tlas_cases(device) -> list[dict]:
    """The two TLAS traces, measured."""
    bvh, cases = tlas_traces(device)
    return [measure(bvh, case) for case in cases]


def probe_trace(renderer) -> dict:
    """The probe case through ``renderer``'s scene, closest-hit, t_max
    PROBE_T_MAX."""
    o, d = probe_case(renderer.scene, renderer.device)
    return dict(label=f"probes {PROBES}x{PROBE_RAYS} closest", origins=o, directions=d,
                t_max=PROBE_T_MAX, any_hit=False)


def probe_cases(renderer) -> list[dict]:
    """The probe case, measured."""
    return [measure(renderer.scene_arrays.bvh, probe_trace(renderer))]


def edge_checks(device) -> list[str]:
    """The edge cases and the overflowing chain at each of OVERFLOW_STEPS,
    each held bit for bit against the plain walk (raises otherwise);
    returns one line per case."""
    lines = []
    for case in edge_cases(device):
        res = compare(case["bvh"], case["origins"], case["directions"], case["t_max"],
                      case["any_hit"], case["label"])
        lines.append(f"{case['label']}: kernel == plain bit for bit, hits "
                     f"{res['hit_share']:.4f}, steps {res['steps']}")
    bvh, o, d = overflow_case(device)
    for max_steps in OVERFLOW_STEPS:
        label = f"overflow chain, max_steps {max_steps}"
        res = compare(bvh, o, d, 1e30, False, label, max_steps=max_steps)
        lines.append(f"{label}: kernel == plain bit for bit, hits {res['hit_share']:.4f}, "
                     f"steps {res['steps']}")
    return lines


def ab_compare(other_root: Path, traces: list[tuple], card: str) -> list[dict]:
    """The A/B of ``--other``: for each (bvh, case), this checkout's kernel
    held bit for bit against the plain walk (with its counts and bound) and
    the other checkout's kernel against this one, then device ms of both in
    AB_ROUNDS rounds of (other, this, this, other); returns the rows with
    each side's times and medians."""
    libs = {"this": build_kernels(), "other": load_wrapper(other_root).build_kernels()}
    rows = []
    for bvh, case in traces:
        res = checked(bvh, case)
        args = (bvh, case["origins"], case["directions"], case["t_max"], case["any_hit"])
        runs = {which: device_run(lib, *args) for which, lib in libs.items()}
        for launch, _ in runs.values():
            launch()
        torch.cuda.synchronize()
        assert_equal_bits(hit_of(runs["other"][1]), hit_of(runs["this"][1]),
                          f"{case['label']} (other)", res["rays"])
        times = {which: [] for which in libs}
        for _ in range(AB_ROUNDS):
            for which in ("other", "this", "this", "other"):
                times[which].append(graph_ms(runs[which][0]))
        res.update({f"{w}_device_ms": t for w, t in times.items()})
        res.update({f"{w}_median_ms": statistics.median(t) for w, t in times.items()})
        res["share"] = res["bound_ms"] / res["this_median_ms"]
        res["share_other"] = res["bound_ms"] / res["other_median_ms"]
        speedup = res["other_median_ms"] / res["this_median_ms"]
        print(f"A/B {case['label']}: other {res['other_median_ms']:.4f} ms -> this "
              f"{res['this_median_ms']:.4f} ms (x{speedup:.3f}), device ms medians of "
              f"{2 * AB_ROUNDS}: other {sorted(times['other'])}, this "
              f"{sorted(times['this'])}; equal bit for bit; bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}), share {res['share_other']:.1%} -> {res['share']:.1%}; "
              f"steps {res['steps']} (worst ray {res['max_steps']}), transforms "
              f"{res['inst_steps']} [{card}]", flush=True)
        rows.append(res)
    return rows


def occupancy_line(lib) -> str:
    """Resident warps an SM holds of each kernel of ``lib``."""
    return ("resident warps a SM: closest-hit "
            f"{lib.bvh_trace_warps_per_sm(0)}, any-hit {lib.bvh_trace_warps_per_sm(1)} of 64")


def describe(res: dict, card: str) -> str:
    return (f"trace {res['name']}: {res['rays']} rays, kernel == plain bit for bit, hits "
            f"{res['hit_share']:.4f}, steps {res['steps']} (worst ray {res['max_steps']}), "
            f"{res['node_steps']} node steps, {res['triangle_tests']} triangle tests, "
            f"{res['inst_steps']} transforms; wrapper {res['ms']:.4f} ms, device "
            f"{res['device_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms; bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}), {res['share']:.1%} of it [{card}]")


def main(argv=None) -> None:
    from arkoserenderer_torch.tools import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="root of another checkout whose kernel to compare with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_bench: torch.cuda.is_available() is False; this needs a GPU")
    card = card_line()
    print(card, flush=True)
    lib = build_kernels()
    for line in ptxas_report(lib):
        print(f"  {line}", flush=True)
    print(occupancy_line(lib), flush=True)
    dev = torch.device("cuda")
    renderer = bench.build_renderer("rt", device=dev)
    flagship = bench.build_renderer("flagship", device=dev)
    if args.other is not None:
        traces = [(case["bvh"], case) for case in frame_traces(renderer)]
        traces.append((renderer.scene_arrays.bvh, probe_trace(renderer)))
        tlas_bvh, cases = tlas_traces(dev)
        traces += [(tlas_bvh, case) for case in cases]
        traces += [(case["bvh"], case) for case in ddgi_traces(flagship)]
        rows = ab_compare(args.other.resolve(), traces, card)
        print(json.dumps({"ab": rows, "card": card, "other": str(args.other)}))
        return
    results = (frame_cases(renderer) + probe_cases(renderer) + tlas_cases(dev)
               + ddgi_cases(flagship))
    for res in results:
        print(describe(res, card), flush=True)
    for line in edge_checks(dev):
        print(line, flush=True)
    print(json.dumps({"traces": results, "card": card}))


if __name__ == "__main__":
    main()
