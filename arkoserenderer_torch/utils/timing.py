"""Per-pass timing on the card (port of arkoserenderer_tpu/utils/timing.py),
with CUDA events.

``time_passes`` times the whole frame first, so the headline row always
lands: frames fed forward serially through their persistent outputs, as a
frame loop runs them, through a compiled frame of its own (the captured
frame, as the reference times its jitted frame; its own graphs and
buffers, so the caller's frames and persistent state are left as they
were). Then it times each pass as the reference times each pass's own
jitted program: frames of that compiled frame replayed as the chain of
per-pass graphs (``rendering/capture.CompiledFrame`` with
``pass_events``), a CUDA event between each two passes, each pass's mean
over ``iters`` frames, until ``deadline_s`` runs out; a pipeline that
cannot be captured runs those frames eagerly with events around each pass.
``emit`` receives each row as it lands, so a process cut short still
leaves a partial table.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from arkoserenderer_torch.rendering.capture import CompiledFrame
from arkoserenderer_torch.rendering.pipeline import RenderPipeline
from arkoserenderer_torch.scene.camera import CameraState
from arkoserenderer_torch.scene.scene import SceneArrays


def _events_ms(fn, iters: int) -> tuple[float, object]:
    """Mean ms of ``iters`` calls of ``fn`` between two CUDA events, after
    one warm-up call; returns (ms, the last call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def time_passes(
    pipe: RenderPipeline,
    state: dict,
    scene: SceneArrays,
    camera: CameraState,
    frame_index: int = 1,
    iters: int = 5,
    deadline_s: float | None = None,
    emit: Callable[[str], None] | None = None,
) -> dict[str, float]:
    """{name: ms} with "<frame>" (the whole frame) first, then each pass.
    The frames start from the pipeline's initial state (``state``, the
    reference's argument, is not read). The pipeline must be on the card;
    on another device it raises RuntimeError."""
    if pipe.device.type != "cuda":
        raise RuntimeError("time_passes times the card; the pipeline is on " + str(pipe.device))
    t_start = time.perf_counter()
    results: dict[str, float] = {}

    def note(name: str, ms: float) -> None:
        results[name] = ms
        if emit is not None:
            emit(f"{name:24s} {ms:9.3f} ms")

    persistent = set(pipe.registry.persistent_names)
    cur = {"state": pipe.initial_state()}
    frame_fn = CompiledFrame(pipe) if pipe.captured else pipe.frame_fn

    def frame(pass_events=None):
        fed = {k: v for k, v in cur["state"].items() if k in persistent}
        cur["state"] = frame_fn(fed, scene, camera, frame_index, pass_events=pass_events)
        return cur["state"]

    frame()  # the first frame's graph (the cached sun renders); _events_ms adds the steady one
    note("<frame>", _events_ms(frame, iters)[0])

    per: dict[str, list[float]] = {}
    frame(pass_events=[])  # the chain's capture
    for i in range(iters):
        if deadline_s is not None and time.perf_counter() - t_start > deadline_s:
            if emit is not None:
                emit(f"# deadline {deadline_s:.0f}s reached; per-pass rows over {i} of "
                     f"{iters} frames")
            break
        events: list = []
        frame(pass_events=events)
        torch.cuda.synchronize()
        for name, start, end in events:
            per.setdefault(name, []).append(start.elapsed_time(end))
    for name, ms in per.items():
        note(name, sum(ms) / len(ms))
    return results


def format_timings(timings: dict[str, float], budget_ms: float = 16.667) -> str:
    lines = [f"{'pass':24s} {'ms':>9s}   vs 16.667 ms budget"]
    for name, ms in timings.items():
        flag = "" if ms < budget_ms else "  <-- over budget"
        lines.append(f"{name:24s} {ms:9.3f}{flag}")
    return "\n".join(lines)
