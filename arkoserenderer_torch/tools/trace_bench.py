"""Measurements of the BVH traversal kernel (csrc/bvh_trace.cu) on the card.

Helpers used by chip_smoke.py: the rays of one frame's traces captured as
the frame makes them (``capture_traces``), random rays through a 4,096-
instance TLAS (``tlas_case``), the kernel held bit for bit against its plain
torch version with the per-ray step counts the plain walk reports
(``compare``), the kernel's bound from those counts (``bound_ms``), and its
times: the wrapper's (CUDA events around back-to-back ``trace_rays_cuda``
calls, as the frame calls it), the device's (a CUDA graph of launches
through the C entry point into outputs made once) and the plain version's.

Run as a script it does all of that for the five traces of one 1920x1080
``rt`` frame (sun mask, spot mask, reflection, and the sun and spot
occlusion rays at the reflection hits) and for the TLAS case:

    python -m arkoserenderer_torch.tools.trace_bench

Prints the card line, one line per case, and one JSON line. Needs a GPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from arkoserenderer_torch.ops import bvh as bvh_ops
from arkoserenderer_torch.ops import bvh_cuda
from arkoserenderer_torch.ops.raster_cuda import build_kernels, ptxas_report
from arkoserenderer_torch.tools.raster_bench import (
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    card_line,
    events_ms,
    graph_ms,
)

# FP32 operations of the kernel (csrc/bvh_trace.cu), counted from its
# source, each mul, add, min, max, compare and division as one: every step
# transforms the ray into the current space (18 mul/add for the origin, 18
# for the direction, 3 guarded divisions); each triangle a quad step tests
# costs 53 (two cross products, four dot products, the division, the
# barycentric and t comparisons); a node step slab-tests 8 children at 25
# each, and a closest-hit node step sorts them with 19 compare-exchanges
# (any-hit skips the sort). The rate they are held to, FP32_OPS_PER_S, is
# the card's published FP32 peak, which counts a fused multiply-add as two
# operations; the kernel is built with --fmad=false, so each counted
# operation is an instruction of its own and the card executes them at no
# more than half that rate: the operations bound is optimistic by up to 2x.
OPS_STEP = 42
OPS_TRIANGLE = 53
OPS_SLAB = 8 * 25
OPS_SORT = 19
WRAPPER_CALLS = 20  # back-to-back wrapper calls under CUDA events
TLAS_INSTANCES = 4096
TLAS_RAYS = 1 << 20


def capture_traces(renderer) -> list[dict]:
    """Render one frame of ``renderer`` and return the inputs of each trace
    it makes, in order: {label, origins, directions, t_max (a float or a
    per-ray tensor), any_hit}, as copies on the card."""
    captured = []
    kernel = bvh_cuda.trace_rays_cuda

    def record(bvh, origins, directions, t_max=1e30, any_hit=False, label=None, **kw):
        tm = t_max.clone() if isinstance(t_max, torch.Tensor) else t_max
        captured.append(dict(label=label, origins=origins.clone(),
                             directions=directions.clone(), t_max=tm, any_hit=any_hit))
        return kernel(bvh, origins, directions, t_max=t_max, any_hit=any_hit, label=label, **kw)

    record.launches = kernel.launches
    record.launches_by_label = kernel.launches_by_label
    bvh_cuda.trace_rays_cuda = record
    try:
        renderer.render_frame()
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


def compare(bvh, origins, directions, t_max, any_hit: bool, label: str) -> dict:
    """The kernel against ``trace_wide_plain`` on the same rays: raises
    unless t, tri, u, v and hit are equal bit for bit; returns the hit
    share and the plain walk's step counts (summed, and the worst ray's)."""
    hk = bvh_cuda.trace_rays_cuda(bvh, origins, directions, t_max=t_max, any_hit=any_hit)
    stats: dict = {}
    hp = bvh_ops.trace_wide_plain(bvh, origins, directions, t_max=t_max, any_hit=any_hit,
                                  stats=stats)
    torch.cuda.synchronize()
    bits = {k: (getattr(hk, k).view(torch.int32) if getattr(hk, k).dtype == torch.float32
                else getattr(hk, k)) for k in hk._fields}
    for k in hk._fields:
        ref = getattr(hp, k)
        ref = ref.view(torch.int32) if ref.dtype == torch.float32 else ref
        if not torch.equal(bits[k], ref):
            raise AssertionError(f"{label}: kernel != plain in {k} on "
                                 f"{int((bits[k] != ref).sum())} of {origins.shape[0]} rays")
    return {"rays": origins.shape[0], "hit_share": hk.hit.float().mean().item(),
            "steps": int(stats["steps"].sum()), "max_steps": int(stats["steps"].max()),
            "node_steps": int(stats["node_steps"].sum()),
            "triangle_tests": int(stats["triangle_tests"].sum()), "max_abs_err": 0.0}


def bound_ms(bvh, n_rays: int, per_ray_t_max: bool, any_hit: bool,
             counts: dict) -> tuple[float, str]:
    """The least time the card could take for one trace: the larger of the
    bytes it must move (each ray's origin, direction and t_max read once,
    t, tri, u and v written once, and the three record pools read once) over
    the HBM rate, and the operations the plain walk's step counts imply
    (``OPS_*``; no sort for any-hit) over the float32 rate."""
    rec_bytes = sum(getattr(bvh, k).numel() * 4 for k in bvh_cuda.RECORD_WIDTHS)
    nbytes = n_rays * (24 + (4 if per_ray_t_max else 0) + 16) + rec_bytes
    ops = (counts["steps"] * OPS_STEP + counts["triangle_tests"] * OPS_TRIANGLE
           + counts["node_steps"] * (OPS_SLAB + (0 if any_hit else OPS_SORT)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_trace(bvh, origins, directions, t_max, any_hit: bool) -> dict:
    """Wrapper ms (CUDA events around back-to-back calls), device ms (a
    CUDA graph of launches through the C entry point) and plain ms."""
    lib = build_kernels()
    r = origins.shape[0]
    dev = origins.device
    t_ray = (torch.broadcast_to(t_max, (r,)).contiguous()
             if isinstance(t_max, torch.Tensor) else None)
    outs = [torch.empty((r,), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    scalar = 1e30 if t_ray is not None else float(t_max)
    ms = events_ms(lambda: bvh_cuda.trace_rays_cuda(bvh, origins, directions, t_max=t_max,
                                                    any_hit=any_hit), WRAPPER_CALLS)
    device_ms = graph_ms(lambda: bvh_cuda.launch_raw(lib, bvh, origins, directions, t_ray,
                                                     scalar, 1e-4, any_hit, 512, *outs))
    plain_ms = events_ms(lambda: bvh_ops.trace_wide_plain(bvh, origins, directions, t_max=t_max,
                                                          any_hit=any_hit), 1)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms}


def measure(bvh, case: dict) -> dict:
    """compare + bound + times of one captured or built trace."""
    args = (bvh, case["origins"], case["directions"], case["t_max"], case["any_hit"])
    res = {"name": case["label"], "any_hit": case["any_hit"],
           "per_ray_t_max": isinstance(case["t_max"], torch.Tensor)}
    res.update(compare(*args, case["label"]))
    res["bound_ms"], res["bound_by"] = bound_ms(bvh, res["rays"], res["per_ray_t_max"],
                                                res["any_hit"], res)
    res.update(time_trace(*args))
    res["share"] = res["bound_ms"] / res["device_ms"]
    return res


def frame_cases(renderer) -> list[dict]:
    """Every trace of one frame of ``renderer`` (after a warm-up frame),
    measured."""
    renderer.render_frame()
    bvh = renderer.scene_arrays.bvh
    return [measure(bvh, case) for case in capture_traces(renderer)]


def tlas_cases(device) -> list[dict]:
    """Closest-hit and any-hit (per-ray t_max) random rays through the
    4,096-instance TLAS, measured."""
    bvh, o, d, tm = tlas_case(device)
    return [measure(bvh, dict(label=f"tlas{TLAS_INSTANCES} closest", origins=o, directions=d,
                              t_max=1e30, any_hit=False)),
            measure(bvh, dict(label=f"tlas{TLAS_INSTANCES} any-hit t_max", origins=o,
                              directions=d, t_max=tm, any_hit=True))]


def describe(res: dict, card: str) -> str:
    return (f"trace {res['name']}: {res['rays']} rays, kernel == plain bit for bit, hits "
            f"{res['hit_share']:.4f}, steps {res['steps']} (worst ray {res['max_steps']}), "
            f"{res['node_steps']} node steps, {res['triangle_tests']} triangle tests; "
            f"wrapper {res['ms']:.4f} ms, device {res['device_ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
            f"{res['share']:.1%} of it [{card}]")


def main(argv=None) -> None:
    from arkoserenderer_torch.tools import bench

    if not torch.cuda.is_available():
        raise SystemExit("trace_bench: torch.cuda.is_available() is False; this needs a GPU")
    card = card_line()
    print(card, flush=True)
    for line in ptxas_report(build_kernels()):
        print(f"  {line}", flush=True)
    dev = torch.device("cuda")
    results = frame_cases(bench.build_renderer("rt", device=dev)) + tlas_cases(dev)
    for res in results:
        print(describe(res, card), flush=True)
    print(json.dumps({"traces": results, "card": card}))


if __name__ == "__main__":
    main()
