"""Pixel-band sharding over ``torch.distributed`` (port of
arkoserenderer_tpu/parallel/sharded.py).

The frame is split by rows into ``n`` horizontal bands, one a rank (one
process a band); the scene is replicated, and the few exchanges between
bands are collectives of the band group:

  * each rank rasters and shades its own band (the camera raster at its
    ``y_offset``, through the raster kernel on the card);
  * the sun map is rastered in ``n`` bands of its rows and gathered, so
    every band samples all of it (passes/shadow.py);
  * the bloom pyramid and the SSAO blur take one halo row from each
    neighbouring band (``ops.image.band_halo_rows``); SSAO's occlusion
    fetches read the gathered depth;
  * the RT denoisers run replicated over gathered full-frame planes and
    each rank cuts its band back out (passes/rt.py).

The reference builds these from ``all_gather`` and ``ppermute`` over a
mesh axis; here every exchange is ``dist.all_gather``, which gloo also
takes for CUDA tensors (gloo has no send/recv for them). Backends are
named, never guessed: "gloo" on the CPU, "nccl" with one rank a card,
"gloo" with CUDA tensors when several ranks share one card (NCCL refuses
two ranks on one device).

``run_bands(fn, n, backend, devices, *args)`` spawns the ranks, joins them
into one group through a ``file://`` store under a temporary directory and
returns rank 0's ``fn(band, *args)``; ``ShardedRenderer`` is the Renderer
of one rank's band. Under ``torchrun`` a rank makes its group itself with
``init_band``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import shutil
import tempfile
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from arkoserenderer_torch.models.standard import Renderer
from arkoserenderer_torch.rendering.pipeline import PipelineConfig
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.scene import Scene

AXIS = "px"
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class BandGroup:
    """One rank's place among the bands and the collectives that join them.

    ``collective_ms``, when a list (on the card), gets a pair of CUDA events
    around each collective this rank makes (read with
    ``collective_times``); ``gathered_bytes`` counts the bytes this rank
    receives."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None  # the torch.distributed group; None: the default one
    collective_ms: list | None = None
    gathered_bytes: int = 0

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (of one shape on all ranks), in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        timed = self.collective_ms is not None
        if timed:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        dist.all_gather(parts, x, group=self.group)
        if timed:
            events[1].record()
            self.collective_ms.append(events)
        self.gathered_bytes += x.numel() * x.element_size() * self.size
        return parts

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The bands' ``x`` stacked along dim 0 in rank order: the full
        frame from each rank's band (``all_gather(..., tiled=True)``)."""
        return torch.cat(self.all_gather(x), dim=0)

    def gather_rows_many(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        """``gather_rows`` of several tensors of one row count and dtype,
        in one collective: their rows side by side, gathered, split."""
        flat = [x.reshape(x.shape[0], -1) for x in xs]
        full = self.gather_rows(torch.cat(flat, dim=1))
        out, at = [], 0
        for x, f in zip(xs, flat):
            out.append(full[:, at:at + f.shape[1]].reshape(full.shape[0], *x.shape[1:]))
            at += f.shape[1]
        return out

    def band_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's band of the full-frame ``x`` (rows split evenly)."""
        h = x.shape[0] // self.size
        return x[self.rank * h:(self.rank + 1) * h]

    def collective_times(self) -> list[float]:
        """The ms of each collective timed since ``collective_ms`` was set
        (synchronises the card)."""
        torch.cuda.synchronize(self.device)
        return [start.elapsed_time(end) for start, end in self.collective_ms]


def init_band(rank: int, size: int, backend: str, device, init_method: str) -> BandGroup:
    """Join the process group of ``size`` ranks at ``init_method`` (a
    ``file://`` or ``tcp://`` address) as ``rank`` and return its band."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs one CUDA device a rank")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)  # n ranks share the cores
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank)
    return BandGroup(rank=rank, size=size, device=device, backend=backend)


def default_devices(n_devices: int, backend: str) -> list[str]:
    """One card a rank under nccl; every rank on the one card under gloo."""
    return [f"cuda:{i}" for i in range(n_devices)] if backend == "nccl" else ["cuda"] * n_devices


def _rank_main(rank: int, fn: Callable, n_devices: int, backend: str, devices: list,
               store: str, result: str, args: tuple) -> None:
    band = init_band(rank, n_devices, backend, devices[rank], f"file://{store}")
    try:
        out = fn(band, *args)
        if rank == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


def run_bands(fn: Callable, n_devices: int, backend: str = "nccl", devices=None,
              *args):
    """Run ``fn(band, *args)`` on ``n_devices`` spawned ranks and return
    rank 0's result (saved with ``torch.save``: keep it on the host).
    ``fn`` must be importable by name (a module-level function of a
    package: the ranks import it, not the caller's script). ``devices``
    names each rank's device (``["cpu"] * n`` on the CPU); by default
    ``default_devices``. A rank that raises fails the call."""
    devices = list(devices or default_devices(n_devices, backend))
    if len(devices) != n_devices:
        raise ValueError(f"{n_devices} ranks need {n_devices} devices, got {devices}")
    tmp = tempfile.mkdtemp(prefix="arkose_bands_")
    try:
        result = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_rank_main, args=(fn, n_devices, backend, devices,
                                             os.path.join(tmp, "store"), result, args),
                           nprocs=n_devices, join=True, start_method="spawn")
        return torch.load(result, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def band_config(cfg: PipelineConfig, n_devices: int) -> PipelineConfig:
    """Full-frame config -> the config of one of ``n_devices`` bands."""
    assert cfg.height % n_devices == 0, "frame height must split evenly"
    band_h = cfg.height // n_devices
    assert band_h % cfg.raster.tile_h == 0, "band height must tile evenly"
    assert cfg.shadow_map_size % n_devices == 0
    return dataclasses.replace(cfg, height=band_h, full_height=cfg.height, shard_axis=AXIS,
                               shard_count=n_devices)


class ShardedRenderer(Renderer):
    """The Renderer of one rank's band: ``cfg`` is the full frame's, the
    pipeline renders ``band_config(cfg, band.size)`` on ``band.device``.

    Persistent state lives in each rank: the band-shaped resources (TAA
    history, the RT histories, ...) hold the band, the rest (the cached sun
    map, the DDGI atlases, the version counters) are replicated and stay
    equal across ranks. ``render_frame()`` returns the rank's LDR band;
    ``gather_frame()`` the full LDR, gathered from every rank (a
    collective: every rank calls it). ``ddgi=True`` fits the probe grid to
    the scene as Renderer does. Eye adaption would meter each band apart,
    so ``auto_exposure`` is refused."""

    def __init__(self, scene: Scene, camera: Camera, cfg: PipelineConfig, band: BandGroup,
                 **pipeline_kw):
        if pipeline_kw.get("auto_exposure"):
            raise ValueError("ShardedRenderer meters no exposure: each band would adapt apart")
        self.band = band
        self.full_cfg = cfg
        super().__init__(scene, camera, band_config(cfg, band.size), device=band.device,
                         **pipeline_kw)
        self.pipeline.band = band

    def reconstruct(self, rebuild_passes: bool = False) -> None:
        super().reconstruct(rebuild_passes)
        self.pipeline.band = self.band

    def gather_frame(self) -> torch.Tensor:
        """The last frame's full LDR, (full height, W, 3) on every rank."""
        return self.band.gather_rows(self.state.get("LDRDisplay", self.state["LDR"]))


@dataclasses.dataclass
class BandJob:
    """A render every rank makes alike: the scene of ``make_scene()`` (a
    function importable by name, or a ``functools.partial`` of one,
    returning (scene, camera)) with ``spots`` appended and, when given, the
    sun's angular radius; ``frames`` frames at the full-frame ``cfg``."""

    make_scene: Callable
    cfg: PipelineConfig
    frames: int = 1
    pipeline_kw: dict = dataclasses.field(default_factory=dict)
    spots: tuple = ()
    sun_angular_radius_deg: float | None = None

    def scene(self):
        scene, camera = self.make_scene()
        scene.spots.extend(copy.deepcopy(list(self.spots)))
        if self.sun_angular_radius_deg is not None:
            scene.sun.angular_radius_deg = self.sun_angular_radius_deg
        return scene, camera


def render_jobs(band: BandGroup, jobs: list[BandJob]) -> list:
    """Each job's last frame, gathered: a list of (H, W, 3) numpy arrays.
    The rank function of ``run_bands(render_jobs, n, backend, devices,
    jobs)``."""
    out = []
    for job in jobs:
        scene, camera = job.scene()
        renderer = ShardedRenderer(scene, camera, job.cfg, band, **job.pipeline_kw)
        renderer.render_frames(job.frames)
        out.append(renderer.gather_frame().cpu().numpy())
    return out
