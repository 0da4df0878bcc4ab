"""What the per-layer readers take from the program's own tracing: the
frame record of the renderer the run measured, and the program's spans in
the traced stretch's trace.

The frame record (``arkoserenderer_torch.utils.profiling.FrameRecord``) is
a ring that every frame writes: its index, a device timestamp before the
first pass and after each pass, the passes' counters, and the host zones'
milliseconds. The harness releases its renderer before the readers run;
the program keeps its latest record (``latest_frame_record``), and the
readers read that. A program that keeps none gives None, and so does every
reader of the record below.

The window's frames are found from data, not from the harness's order of
frames: the traced stretch's spans are labelled ``arkose.frame#<i>``, so
its first frame is the least such i, and the window is the
``len(ctx.host_ms)`` frames just before it. Where the labels are not
``ctx.frames_traced`` frames in a row, or the record lacks a window frame,
the readers read nothing.

The program's spans are the ``user_annotation`` events named ``arkose.*``;
a span's label may add ``#<frame>`` or `` (<detail>)`` to its name.
"""

from __future__ import annotations

import bisect
import importlib

import numpy as np

from .harness import PROGRAM

SPAN_PREFIX = "arkose."
FRAME_SPAN = "arkose.frame"


def latest_rows(ctx) -> dict | None:
    """The program's latest frame record, read back once a run (kept on
    ``ctx``); None where the program keeps none."""
    if not hasattr(ctx, "frame_rows"):
        rows = None
        try:
            prof = importlib.import_module(f"{PROGRAM}.utils.profiling")
        except ImportError:
            prof = None
        latest = getattr(prof, "latest_frame_record", None)
        record = latest() if latest is not None else None
        if record is not None:
            rows = record.rows()
        ctx.frame_rows = rows
    return ctx.frame_rows


def select(rows: dict, first: int, count: int) -> dict | None:
    """The rows of frames ``first`` .. ``first + count - 1``, or None
    unless the record holds each of them (a ring keeps the latest)."""
    keep = (rows["frame_index"] >= first) & (rows["frame_index"] < first + count)
    if int(keep.sum()) != count:
        return None
    return {**rows, "frame_index": rows["frame_index"][keep],
            "stamps_ns": rows["stamps_ns"][keep],
            "counters": {k: v[keep] for k, v in rows["counters"].items()},
            "host_ms": {k: v[keep] for k, v in rows.get("host_ms", {}).items()}}


def traced_frames(trace) -> list[int]:
    """The frame indices of the trace's ``arkose.frame#<i>`` spans, sorted."""
    return sorted(int(name.split(" (", 1)[0].split("#", 1)[1])
                  for _, _, name, cat in trace.host_ops
                  if cat == "user_annotation" and span_name(name) == FRAME_SPAN
                  and "#" in name)


def window_rows(ctx) -> dict | None:
    """The record's rows of the window's frames: the ``len(ctx.host_ms)``
    frames before the traced stretch's first; None where the record or the
    labels are missing, or disagree (the labels are not ``frames_traced``
    frames in a row, or the record lacks one of them or a window frame)."""
    rows = latest_rows(ctx)
    traced = traced_frames(ctx.trace)
    window = len(ctx.host_ms)
    if rows is None or not window or not traced or len(traced) != ctx.frames_traced \
            or traced != list(range(traced[0], traced[0] + len(traced))) \
            or select(rows, traced[0], len(traced)) is None:
        return None
    return select(rows, traced[0] - window, window)


def pass_ms(rows: dict) -> dict[str, np.ndarray]:
    """Each pass's milliseconds in each frame: the difference of the
    timestamps around it."""
    d = np.diff(rows["stamps_ns"].astype(np.float64), axis=1) * 1e-6
    return {name: d[:, k] for k, name in enumerate(rows["passes"])}


def window_pass_ms(ctx, name: str) -> np.ndarray | None:
    """Pass ``name``'s milliseconds in each window frame, on the device's
    clock; None where the record is missing, on the host's clock, or has no
    such pass."""
    rows = window_rows(ctx)
    if rows is None or rows["clock"] != "globaltimer" or name not in rows["passes"]:
        return None
    return pass_ms(rows)[name]


def span_name(label: str) -> str:
    """A span's name without the ``#<frame>`` and `` (<detail>)`` of its
    label."""
    return label.split(" (", 1)[0].split("#", 1)[0]


def program_spans(trace) -> list[tuple[float, float, str]]:
    """(start us, end us, name) of the program's spans in a ``Trace``."""
    return [(s, s + d, span_name(name)) for s, d, name, cat in trace.host_ops
            if cat == "user_annotation" and name.startswith(SPAN_PREFIX)]


def innermost(spans: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """The time each span is the innermost program span: its interval less
    its children's (spans nest, as the profiler records them)."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out: list = []
    stack: list = []  # [start of the open piece, end, name]

    def close_until(t):
        while stack and stack[-1][1] <= t:
            s, e, n = stack.pop()
            if e > s:
                out.append((s, e, n))
            if stack:
                stack[-1][0] = e

    for s, e, n in spans:
        close_until(s)
        if stack and s > stack[-1][0]:
            out.append((stack[-1][0], s, stack[-1][2]))
        stack.append([s, e, n])
    close_until(float("inf"))
    return out


def busy_us_in(merged: list, starts: list, a: float, b: float) -> float:
    """Device-busy microseconds of ``merged`` (sorted disjoint [s, e], whose
    starts are ``starts``) in [a, b]."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    busy = 0.0
    while k < len(merged) and merged[k][0] < b:
        busy += max(0.0, min(b, merged[k][1]) - max(a, merged[k][0]))
        k += 1
    return busy


def idle_us_under(trace, name: str) -> float | None:
    """Microseconds of the traced span (first device operation to the last)
    in which no device operation ran while ``name`` was the innermost
    program span; None where the trace has no device operation."""
    if not trace.merged:
        return None
    t0, t1 = trace.merged[0][0], trace.merged[-1][1]
    starts = [m[0] for m in trace.merged]
    idle = 0.0
    for s, e, n in innermost(program_spans(trace)):
        if n != name:
            continue
        a, b = max(s, t0), min(e, t1)
        if b > a:
            idle += (b - a) - busy_us_in(trace.merged, starts, a, b)
    return idle


def clock_fit(kernel_start_us, stamp_ns) -> tuple[float, np.ndarray]:
    """The record's clock on the trace's: (offset us, residuals us) with
    ``trace_us = stamp_ns / 1e3 + offset``, the offset the median of the
    pairs' differences."""
    d = np.asarray(kernel_start_us, np.float64) - np.asarray(stamp_ns, np.float64) * 1e-3
    offset = float(np.median(d))
    return offset, d - offset
