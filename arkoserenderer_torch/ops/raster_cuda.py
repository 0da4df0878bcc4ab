"""Wrapper of the hand-written stage-4 raster kernel (csrc/raster_tiles.cu),
and the build of the port's kernel library.

``build_kernels()`` compiles ``csrc/*.cu`` with nvcc (one process per
source, in parallel) into a shared library with a plain C interface under
``build/kernels/`` at the checkout root (the library name carries a hash of
the sources, so an edit rebuilds), and loads it with ctypes. ``rasterize_tiles_cuda`` checks its inputs, allocates the
outputs with ``torch.empty`` and launches on the current stream without
synchronising; ``rasterize_tiles_cuda.launches`` counts its launches, and
``rasterize_tiles_cuda.launches_by_shape`` counts them per
(height, width, depth_only).

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false`` and no
fast math, so the kernel rounds every operation as eager torch does and
equals ``ops.raster.rasterize_tiles_plain`` bit for bit. ``-Xptxas=-v``
reports each kernel's registers, shared memory and spills; the report is
kept beside the library (``ptxas_report(lib)``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from arkoserenderer_torch.core.types import VIS_NONE, RasterConfig
from arkoserenderer_torch.ops.raster import TileBins, TriSetup, num_tiles

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

MAX_THREADS = 128  # threads a block (csrc/raster_tiles.cu)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_kernels() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` (once per source version, into ``BUILD_DIR``)
    and load the port's kernel library: one ``nvcc -c`` per source, all
    started together, then one link."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libarkose_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        outs = [p.communicate() for p in procs]
        failed = [f"{src.name}:\n{err}" for src, p, (_, err) in zip(sources, procs, outs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        for obj in objs:
            obj.unlink()
        so.with_suffix(".ptxas.txt").write_text("".join(err for _, err in outs))
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.raster_tiles_launch.argtypes = [p] * 10 + [i] * 9 + [p]
    lib.raster_tiles_launch.restype = i
    lib.bvh_trace_launch.argtypes = [p] * 6 + [f, f] + [i] * 4 + [p] * 6
    lib.bvh_trace_launch.restype = i
    lib.bvh_trace_warps_per_sm.argtypes = [i]
    lib.bvh_trace_warps_per_sm.restype = i
    lib.frame_stamp_launch.argtypes = [p, p] + [i] * 5 + [p]
    lib.frame_stamp_launch.restype = i
    lib.frame_count_launch.argtypes = [p, p] + [i] * 3 + [p, i, p]
    lib.frame_count_launch.restype = i
    lib.packed_shading_launch.argtypes = [p, p]
    lib.packed_shading_launch.restype = i
    lib.packed_shading_args_size.argtypes = []
    lib.packed_shading_args_size.restype = i
    _lib = lib
    return lib


def ptxas_report(lib: ctypes.CDLL) -> list[str]:
    """ptxas's lines on registers, shared memory and spills from the build
    of ``lib``."""
    text = Path(lib._name).with_suffix(".ptxas.txt").read_text()
    return [line.strip() for line in text.splitlines() if "ptxas info" in line or "spill" in line]


def check_tile(cfg: RasterConfig) -> None:
    """Raise ValueError unless the kernel takes ``cfg``'s tile. As
    ``raster_tiles_launch`` decides it: tile_w <= 128 (one thread a column),
    R row groups with R the largest divisor of tile_h such that
    tile_w * R <= 128, and tile_h / R rows a thread in 1, 2, 4, 8 or 16.
    So 8x16 and 8x128 are taken; 32x128, 64x64 and 8x256 are not."""
    groups = next((r for r in range(cfg.tile_h, 0, -1)
                   if cfg.tile_h % r == 0 and cfg.tile_w * r <= MAX_THREADS), 1)
    if not (0 < cfg.tile_w <= MAX_THREADS and cfg.tile_h // groups in (1, 2, 4, 8, 16)):
        raise ValueError(f"the raster kernel does not take tile {cfg.tile_h}x{cfg.tile_w}: it "
                         "takes tile_w <= 128 with 1, 2, 4, 8 or 16 rows a thread")


def _check(name, t: torch.Tensor, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rasterize_tiles_cuda(
    setup: TriSetup,
    bins: TileBins,
    width: int,
    height: int,
    cfg: RasterConfig,
    depth_only: bool = False,
    y_offset: int = 0,
    depth_limit: torch.Tensor | None = None,
):
    """The kernel behind ``ops.raster.rasterize_tiles`` for CUDA tensors;
    same contract. Returns (vis (H,W) i32, depth (H,W) f32)."""
    check_tile(cfg)
    nty, ntx = num_tiles(width, height, cfg)
    n_setup = setup.screen_xy.shape[0]
    dev = setup.screen_xy.device
    _check("screen_xy", setup.screen_xy, torch.float32, (n_setup, 3, 2))
    _check("z_ndc", setup.z_ndc, torch.float32, (n_setup, 3))
    _check("sorted_tris", bins.sorted_tris, torch.int32)
    _check("starts", bins.starts, torch.int32, (nty * ntx,))
    _check("counts", bins.counts, torch.int32, (nty * ntx,))
    _check("global_tris", bins.global_tris, torch.int32)
    _check("global_count", bins.global_count, torch.int32, ())
    if setup.screen_xy.data_ptr() % 8:
        raise ValueError("screen_xy must be 8-byte aligned (the kernel copies corners as float2)")
    if depth_limit is not None:
        _check("depth_limit", depth_limit, torch.float32, (height, width))
    for t in (bins.sorted_tris, bins.starts, bins.counts, bins.global_tris,
              bins.global_count, setup.z_ndc):
        if t.device != dev:
            raise ValueError("all raster inputs must be on one device")
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    if depth_only:
        vis = torch.full((height, width), VIS_NONE, dtype=torch.int32, device=dev)
    else:
        vis = torch.empty((height, width), dtype=torch.int32, device=dev)
    launch_raw(build_kernels(), setup, bins, width, height, cfg, depth_only, y_offset,
               depth_limit, depth, vis)
    rasterize_tiles_cuda.launches += 1
    rasterize_tiles_cuda.launches_by_shape[(height, width, bool(depth_only))] += 1
    return vis, depth


def launch_raw(lib, setup: TriSetup, bins: TileBins, width: int, height: int,
               cfg: RasterConfig, depth_only: bool, y_offset: int,
               depth_limit: torch.Tensor | None, depth: torch.Tensor, vis: torch.Tensor):
    """One launch of ``lib.raster_tiles_launch`` into the given outputs on the
    current stream, with no checks and no count: ``rasterize_tiles_cuda``
    checks the inputs; timing scripts call this on outputs made once."""
    err = lib.raster_tiles_launch(
        setup.screen_xy.data_ptr(), setup.z_ndc.data_ptr(),
        bins.sorted_tris.data_ptr(), bins.starts.data_ptr(), bins.counts.data_ptr(),
        bins.global_tris.data_ptr(), bins.global_count.data_ptr(),
        None if depth_limit is None else depth_limit.data_ptr(),
        depth.data_ptr(), vis.data_ptr(),
        width, height, cfg.tile_h, cfg.tile_w, int(y_offset), int(depth_only),
        setup.screen_xy.shape[0], bins.sorted_tris.numel(), bins.global_tris.numel(),
        torch.cuda.current_stream(depth.device).cuda_stream,
    )
    if err == 1:  # cudaErrorInvalidValue: a shape or alignment the kernel does not take
        raise ValueError(f"raster_tiles_launch refused tile {cfg.tile_h}x{cfg.tile_w} at "
                         f"{width}x{height} (see check_tile)")
    if err != 0:
        raise RuntimeError(f"raster_tiles_launch failed: CUDA error {err}")


rasterize_tiles_cuda.launches = 0
rasterize_tiles_cuda.launches_by_shape = collections.Counter()
