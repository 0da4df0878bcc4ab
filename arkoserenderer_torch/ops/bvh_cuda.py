"""Wrapper of the hand-written 8-wide BVH traversal kernel
(csrc/bvh_trace.cu), built into the port's kernel library by
``ops/raster_cuda.build_kernels``.

``trace_rays_cuda`` checks its inputs, allocates ``t``, ``tri``, ``u`` and
``v`` and the kernel's ray counter (one int32 of scratch, which the entry
point zeroes on the stream) with ``torch.empty`` and launches on the
current stream without synchronising; ``trace_rays_cuda.launches`` counts
its launches and ``trace_rays_cuda.launches_by_label`` counts them by the
caller's label (the trace of a frame: "sun mask", "reflection", ...).
With the library's flags (``--fmad=false``, no fast math) the kernel
equals ``ops.bvh.trace_wide_plain`` bit for bit.
"""

from __future__ import annotations

import collections

import torch

from arkoserenderer_torch.ops.bvh import Hit, TwoLevelBVH
from arkoserenderer_torch.ops.raster_cuda import _check, build_kernels

RECORD_WIDTHS = {"wide_rec": 56, "quad_rec": 40, "inst_rec": 14}


def trace_rays_cuda(bvh: TwoLevelBVH, origins: torch.Tensor, directions: torch.Tensor,
                    t_max=1e30, t_eps: float = 1e-4, any_hit: bool = False,
                    max_steps: int = 512, label: str | None = None) -> Hit:
    """The kernel behind ``ops.bvh.trace_rays`` for CUDA tensors; same
    contract. ``t_max`` is a float or a tensor broadcastable to (R,)."""
    r = origins.shape[0]
    _check("origins", origins, torch.float32, (r, 3))
    _check("directions", directions, torch.float32, (r, 3))
    for name, lanes in RECORD_WIDTHS.items():
        rec = getattr(bvh, name)
        _check(name, rec, torch.int32, (rec.shape[0], lanes))
        if rec.device != origins.device:
            raise ValueError(f"{name} must be on the rays' device {origins.device}")
    t_ray = None
    if isinstance(t_max, torch.Tensor):
        t_ray = torch.broadcast_to(t_max.to(torch.float32), (r,)).contiguous()
        _check("t_max", t_ray, torch.float32, (r,))
        if t_ray.device != origins.device:
            raise ValueError("t_max must be on the rays' device")
    dev = origins.device
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    tri = torch.empty((r,), dtype=torch.int32, device=dev)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    v = torch.empty((r,), dtype=torch.float32, device=dev)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    launch_raw(build_kernels(), bvh, origins, directions, t_ray,
               1e30 if t_ray is not None else float(t_max), t_eps, any_hit, max_steps,
               t, tri, u, v, counter)
    trace_rays_cuda.launches += 1
    trace_rays_cuda.launches_by_label[label] += 1
    return Hit(t=t, tri=tri, u=u, v=v, hit=tri >= 0)


def launch_raw(lib, bvh: TwoLevelBVH, origins, directions, t_ray, t_max_all: float,
               t_eps: float, any_hit: bool, max_steps: int, t, tri, u, v, counter) -> None:
    """One launch of ``lib.bvh_trace_launch`` into the given outputs, with
    ``counter`` (one int32 on the card) as the kernel's ray counter, on the
    current stream, with no checks and no count: ``trace_rays_cuda`` checks
    the inputs; timing scripts call this on outputs made once."""
    err = lib.bvh_trace_launch(
        bvh.wide_rec.data_ptr(), bvh.quad_rec.data_ptr(), bvh.inst_rec.data_ptr(),
        origins.data_ptr(), directions.data_ptr(),
        None if t_ray is None else t_ray.data_ptr(), float(t_max_all), float(t_eps),
        int(max_steps), int(bool(any_hit)), origins.shape[0], bvh.quad_rec.shape[0],
        t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), counter.data_ptr(),
        torch.cuda.current_stream(origins.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bvh_trace_launch failed: CUDA error {err}")


trace_rays_cuda.launches = 0
trace_rays_cuda.launches_by_label = collections.Counter()
