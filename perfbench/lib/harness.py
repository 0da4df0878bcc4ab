"""One run of one cell: set-up, the timed window, the traced stretch (with
``--trace 1``), the correctness check and the result line.

The window is a closed frame loop as a game runs it: before submitting
frame n the loop waits for frame n-2 to complete (at most two frames in
flight), the traffic moves the camera, ``Renderer.render_frame`` replays the
captured frame, and a CUDA event recorded after it is the frame's present.
Nothing in the window reads the device back.

  frame_ms      the window's wall time (first submit to the last present,
                after a synchronise) over the frames presented in it
  frame_ms_p95  the 95th percentile of the present intervals (consecutive
                frames' completion events; the first from an event recorded
                at the window's start)
  setup_s       process start to the first timed submit
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
import types

import numpy as np
import torch

from . import check
from .inputs import scene_inputs
from .pkg import package
from .spec import Spec
from .trace import Trace
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "arkoserenderer_tpu")
PROGRAM = "arkoserenderer_torch"
WARM_MAX = 16     # warm-up frames at most
WARM_SETTLE = 2   # frames in a row that capture nothing end the warm-up
TRACE_S = 1.5     # seconds of whole-frame replays under the profiler
CHAIN_FRAMES = 4  # frames replayed as the per-pass chain


class Marks:
    """Frame completion marks: CUDA events on the card, the host clock on
    the CPU (where the tests drive the harness)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True, blocking=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def percentile(values, q: float) -> float:
    """numpy's linear percentile: the ``q``-th of ``values``."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def sized(config: dict, small: bool) -> dict:
    """The configuration, or with ``small`` its ``test_size`` laid over it."""
    return {**config, **config.get("test_size", {})} if small else dict(config)


NOT_IN_PIPELINE = {"width", "height", "shadow_map_size", "raster", "scene"}


def pipeline_config(prog, config: dict, viewport: tuple[int, int]):
    """``PipelineConfig`` of the four fields the harness sets, with the
    configuration's ``pipeline`` entries laid over the defaults."""
    extra = config.get("pipeline", {})
    clash = set(extra) & NOT_IN_PIPELINE
    if clash:
        raise ValueError(f"'pipeline' sets {sorted(clash)}: the harness sets the first four "
                         "from the configuration's top, and the renderer sets 'scene'")
    return prog.PipelineConfig(width=viewport[0], height=viewport[1],
                               shadow_map_size=int(config["shadow_map_size"]),
                               raster=prog.RasterConfig(**config["raster"]), **extra)


def renderer_flags(prog, config: dict, scene) -> dict:
    """The configuration's ``renderer`` flags, a ``ddgi`` grid given as a
    dict turned into the program's ``ProbeGridConfig`` fitted to the
    scene's bounds."""
    flags = dict(config.get("renderer", {}))
    grid = flags.get("ddgi")
    if isinstance(grid, dict):
        grid = {k: tuple(v) if isinstance(v, list) else v for k, v in grid.items()}
        center, radius = scene.bounding_sphere()
        flags["ddgi"] = prog.ProbeGridConfig.fit_bounds(center, radius, **grid)
    return flags


def make_renderer(spec: Spec, config: dict, mix: dict, seed: int, device):
    """(renderer, traffic, compared resource names, the reference's inputs)
    of ``config``, built through the program's entry points, the camera path
    bound. The inputs are read from the authored scene and camera before the
    program builds anything from them."""
    prog = package(PROGRAM)
    traffic = Traffic(mix, seed)
    builder = spec.scene_builder(config["scene"]["builder"])
    viewport = (int(config["width"]), int(config["height"]))
    scene, camera, kw = builder.build(prog, config["scene"], viewport, traffic)
    inputs = scene_inputs(scene, camera)
    inputs["animation"] = builder.animation(scene, traffic)
    base = np.array(camera.position, np.float32)
    inputs["camera_path"] = lambda k: (base + traffic.offset(k)).astype(np.float32)
    cfg = pipeline_config(prog, config, viewport)
    kw.update(renderer_flags(prog, config, scene))
    renderer = prog.Renderer(scene, camera, cfg, device=device, **kw)
    traffic.bind(renderer.camera)
    return renderer, traffic, list(config["compare"]), inputs


def captures(renderer) -> int:
    """CUDA graphs the renderer's compiled frame has captured so far."""
    if not renderer.pipeline.captured:
        return 0
    return renderer.pipeline.compile().captures


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", small: bool = False, spec: Spec | None = None,
             break_program=None, control: bool = False) -> tuple[dict, dict]:
    """One run. Returns (the result line's object, what the log prints).
    ``small`` runs the configuration's ``test_size`` and ``break_program``
    (``fn(renderer)``) plants a fault in the program's renderer: both for
    the tests. ``control`` puts the control in the program's place for the
    verdict: the reference with its float32 matrix products in TF32, judged
    against the float32 reference as the program is (the log keeps the
    program's numbers too)."""
    spec = spec or Spec()
    device = torch.device(device)
    cell = spec.cell(workload)
    config = sized(spec.config(cell["config"]), small)
    mix = spec.traffic(cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32
    torch.backends.cudnn.allow_tf32 = False
    marks = Marks(device)

    parts = {"imports_s": time.perf_counter() - t0}
    t_part = time.perf_counter()
    r, traffic, names, inputs = make_renderer(spec, config, mix, seed, device)
    parts["scene_and_renderer_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    if break_program is not None:
        break_program(r)

    def submit():
        traffic.place(r.camera, r.frame_index)
        r.render_frame()

    # Set-up: frames 0 to START_FRAME (the last kept for the check), then
    # frames until none captures a graph.
    earlier = []
    for f in range(check.START_FRAME + 1):
        submit()
        if f < check.START_FRAME and "Visibility" in names:
            earlier.append(check.grab(r, ["Visibility"], state=False)["Visibility"])
    marks.sync()
    prog_start = check.grab(r, names)
    if earlier:
        prog_start["Visibility.earlier"] = torch.stack(earlier)
    parts["first_frames_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    settled, seen = 0, captures(r)
    for _ in range(WARM_MAX):
        submit()
        now = captures(r)
        settled, seen = (settled + 1, now) if now == seen else (0, now)
        if settled >= WARM_SETTLE:
            break
    if trace and r.pipeline.captured:  # the per-pass chain's graphs
        for _ in range(2):
            traffic.place(r.camera, r.frame_index)
            r.render_frame(pass_events=[])
        seen = captures(r)
    marks.sync()

    parts["warm_up_s"] = time.perf_counter() - t_part

    # The window.
    done, host_ms = [], []
    t_start = time.perf_counter()
    setup_s = t_start - t0
    first = marks.mark()
    while True:
        if len(done) >= 2:
            marks.wait(done[-2])
        if time.perf_counter() - t_start >= seconds and done:
            break
        traffic.place(r.camera, r.frame_index)
        h = time.perf_counter()
        r.render_frame()
        host_ms.append((time.perf_counter() - h) * 1e3)
        done.append(marks.mark())
    marks.sync()
    wall_s = time.perf_counter() - t_start
    frames = len(done)
    gaps = [marks.ms(a, b) for a, b in zip([first] + done[:-1], done)]
    if captures(r) != seen:
        raise RuntimeError("a CUDA graph was captured inside the timed window")
    e2e = {"frame_ms": wall_s * 1e3 / frames, "frame_ms_p95": percentile(gaps, 95),
           "setup_s": setup_s}

    ctx = None
    t_trace = time.perf_counter()
    if trace:
        ctx = traced_stretch(r, traffic, marks, e2e["frame_ms"], config, host_ms)
    trace_s = time.perf_counter() - t_trace

    # The check frame: the timed path's next frame from a copy of its state.
    step_frame = r.frame_index
    step_state = {k: v.detach().to("cpu", copy=True)
                  for k, v in check.persistent(r).items()}
    submit()
    marks.sync()
    prog_step = check.grab(r, names)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    dev_info = device_info(device, peak)
    del r
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = spec.reference(config["reference"])
    t_ref = time.perf_counter()
    ref_start, ref_step = check.reference_frames(ref, inputs, config, device, step_frame,
                                                 step_state)
    ref_s = time.perf_counter() - t_ref
    values = check.numbers(prog_start, prog_step, ref_start, ref_step)
    log = {"reference_s": ref_s, "numbers": values}
    if control:
        c_start, c_step = check.reference_frames(ref, inputs, config, device, step_frame,
                                                 step_state, tf32=True)
        log["program_checks"] = check.verdict(values, config.get("limits", {}))[1]
        values = log["control"] = check.numbers(c_start, c_step, ref_start, ref_step)
    correct, table = check.verdict(values, config.get("limits", {}))
    log["checks"] = table
    found = forbidden_modules()
    if found:
        raise RuntimeError("modules of the JAX package or JAX were loaded: " + ", ".join(found))

    if trace:
        metrics = per_layer_metrics(spec, workload, ctx)
        dev_info["busy_s"] = ctx.trace.busy_us * 1e-6
        dev_info["window_s"] = ctx.trace.window_us * 1e-6
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(workload)}
    result = {"correct": bool(correct), "attempted": frames, "failed": 0, "metrics": metrics,
              "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = table
    if trace:
        log["pass_ms"] = {k: sum(v) / len(v) for k, v in ctx.pass_ms.items()}
    log.update(setup_parts=parts, frames=frames, window_s=wall_s, e2e=e2e, trace_s=trace_s,
               intervals_ms=[percentile(gaps, q) for q in (0, 50, 90, 95, 99, 100)])
    return result, log


def traced_stretch(r, traffic, marks, frame_ms: float, config: dict, host_ms: list):
    """Whole-frame replays under the profiler, then frames replayed as the
    per-pass chain; the context the per-layer readers read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = max(4, min(64, math.ceil(TRACE_S * 1e3 / max(frame_ms, 1e-3))))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if marks.cuda else [])
    done = []
    with profile(activities=acts) as prof:
        for _ in range(n):
            if len(done) >= 2:
                with record_function("perfbench.wait"):
                    marks.wait(done[-2])
            with record_function("perfbench.traffic"):
                traffic.place(r.camera, r.frame_index)
            with record_function("perfbench.render_frame"):
                r.render_frame()
            done.append(marks.mark())
        marks.sync()
    tr = Trace.from_profiler(prof)
    pass_ms: dict = {}
    for _ in range(CHAIN_FRAMES if marks.cuda else 0):
        events: list = []
        traffic.place(r.camera, r.frame_index)
        r.render_frame(pass_events=events)
        marks.sync()
        for name, s, e in events:
            pass_ms.setdefault(name, []).append(s.elapsed_time(e))
    return types.SimpleNamespace(trace=tr, frames_traced=n, pass_ms=pass_ms, host_ms=host_ms,
                                 config=config)


def per_layer_metrics(spec: Spec, workload: str, ctx) -> dict:
    """Each per-layer metric of the cell its reader finds something for."""
    out = {}
    for m in spec.per_layer(workload):
        reader, part = spec.metric_reader(m["name"])
        value = reader.read(ctx, part)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}


def log_lines(result: dict, log: dict) -> list[str]:
    """The log's last lines: each compared number beside its limit last."""
    lines = [f"frames {log['frames']} window_s {log['window_s']:.6f} "
             f"trace_s {log['trace_s']:.3f} reference_s {log['reference_s']:.3f}"]
    lines += [f"{k} {v!r}" for k, v in log["e2e"].items()]
    lines.append("set-up parts: " + " ".join(f"{k}={v:.3f}" for k, v in log["setup_parts"].items()))
    lines.append("present intervals ms, p0 p50 p90 p95 p99 p100: "
                 + " ".join(f"{v:.4f}" for v in log["intervals_ms"]))
    if log.get("pass_ms"):
        lines.append("pass ms (per-pass chain): " + " ".join(
            f"{k}={v:.4f}" for k, v in log["pass_ms"].items()))
    for k, (v, lim) in log.get("program_checks", {}).items():
        lines.append(f"program {k} {v!r} limit {lim!r}")
    lines.append("numbers " + json.dumps(log["numbers"]))
    lines.append(f"correct {result['correct']}")
    lines += [f"check {k} {v!r} limit {lim!r}" for k, (v, lim) in log["checks"].items()]
    return lines

