"""The readers of the program's frame record and spans (``lib/records`` and
the ``graph_pass_ms``, ``geometry``, ``raster.drop_share``, ``host_ms`` and
``device_idle`` metrics) on a made-up context: a record of a run's frames
and a trace of three device operations under the program's spans, whose
``arkose.frame#<i>`` labels name the traced frames. A context without a
record or spans, as a program without them gives, reads nothing, and so
does one whose labels and record disagree."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib import records  # noqa: E402
from perfbench.lib.spec import Spec  # noqa: E402
from perfbench.lib.trace import Trace  # noqa: E402

PASSES = ["Geometry", "SunShadow", "VisibilityShading"]
WARM, WINDOW, TRACED, CHAIN = 2, 5, 3, 2  # then one check frame


def read(name, ctx):
    reader, part = Spec().metric_reader(name)
    return reader.read(ctx, part)


def make_rows(n: int, clock="globaltimer") -> dict:
    """Frames 0..n-1: pass k of frame f takes (k + 1 + f) ms, frames 100 ms
    apart; frame f keeps 10 + f of 100 triangles and drops f of 50 + f bin
    entries in each raster; its camera zone takes f / 10 ms and its fill
    f / 100 ms, and its capture zone did not run (NaN)."""
    f = np.arange(n)
    lengths = (np.arange(len(PASSES))[None, :] + 1 + f[:, None]) * 1_000_000
    start = (1_000_000_000 + f * 100_000_000)[:, None]
    stamps = np.concatenate([start, start + np.cumsum(lengths, axis=1)], axis=1)
    counters = {"geometry.triangles": np.full(n, 100), "geometry.kept": 10 + f,
                "raster.camera_dropped": f, "raster.camera_binned": np.full(n, 50),
                "raster.sun_dropped": f, "raster.sun_binned": np.full(n, 50)}
    host = {"arkose.frame.camera": f / 10, "arkose.frame.fill": f / 100,
            "arkose.frame.capture": np.full(n, np.nan)}
    return {"frame_index": f, "stamps_ns": stamps, "counters": counters, "host_ms": host,
            "passes": PASSES, "clock": clock}


def make_trace(frames=(7, 8, 9)) -> Trace:
    """Device operations at [0, 10], [20, 30] and [40, 50] us; the first
    traced frame's span holds fill over [8, 25] and replay over [25, 45],
    the others' lie after the last device operation."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": t, "dur": 10.0}
          for t in (0.0, 20.0, 40.0)]
    first = frames[0]
    spans = [(f"arkose.frame#{first}", 0.0, 50.0), (f"arkose.frame.fill#{first}", 8.0, 17.0),
             (f"arkose.frame.replay#{first}", 25.0, 20.0), ("perfbench.render_frame", 0.0, 51.0)]
    spans += [(f"arkose.frame#{f}", 60.0 + 10 * k, 5.0) for k, f in enumerate(frames[1:])]
    for name, ts, dur in spans:
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur})
    return Trace(ev)


def make_ctx(rows, trace=None):
    return types.SimpleNamespace(host_ms=[1.0] * WINDOW, frames_traced=TRACED,
                                 pass_ms={"Geometry": [1.0] * CHAIN}, frame_rows=rows,
                                 trace=trace or make_trace(), config={})


def test_the_window_is_anchored_on_the_traced_frames_labels():
    rows = make_rows(WARM + WINDOW + TRACED + CHAIN + 1)
    assert records.traced_frames(make_trace()) == [7, 8, 9]
    assert records.window_rows(make_ctx(rows))["frame_index"].tolist() == list(range(2, 7))
    # The labels, not the record's last frame, place the window.
    later = make_ctx(rows, make_trace((8, 9, 10)))
    assert records.window_rows(later)["frame_index"].tolist() == list(range(3, 8))


@pytest.mark.parametrize("frames", [(7, 8), (7, 9, 10), (12, 13, 14), (1, 2, 3)])
def test_labels_that_disagree_with_the_record_read_nothing(frames):
    """Too few traced frames, a gap, traced frames the record lacks, and a
    window before the record's first frame."""
    ctx = make_ctx(make_rows(WARM + WINDOW + TRACED + CHAIN + 1), make_trace(frames))
    assert records.window_rows(ctx) is None
    assert read("graph_pass_ms.Geometry", ctx) is None and read("host_ms.camera", ctx) is None


@pytest.mark.parametrize("k,name", list(enumerate(PASSES)))
def test_graph_pass_ms_reads_the_window_frames(k, name):
    ctx = make_ctx(make_rows(WARM + WINDOW + TRACED + CHAIN + 1))
    ms = np.array([k + 1 + f for f in range(WARM, WARM + WINDOW)], float)
    assert read(f"graph_pass_ms.{name}", ctx) == pytest.approx(ms.mean())
    assert read(f"graph_pass_ms_p95.{name}", ctx) == pytest.approx(np.percentile(ms, 95))


def test_counter_shares_over_the_window():
    ctx = make_ctx(make_rows(WARM + WINDOW + TRACED + CHAIN + 1))
    f = np.arange(WARM, WARM + WINDOW)
    assert read("geometry.kept_share", ctx) == pytest.approx(100 * (10 + f).sum() / 500)
    dropped = 2 * f.sum()
    assert read("raster.drop_share", ctx) == pytest.approx(100 * dropped / (dropped + 500))


def test_host_zones_over_the_window_and_the_idle_under_the_spans():
    ctx = make_ctx(make_rows(WARM + WINDOW + TRACED + CHAIN + 1))
    f = np.arange(WARM, WARM + WINDOW)
    assert read("host_ms.camera", ctx) == pytest.approx((f / 10).mean())
    assert read("host_ms.fill", ctx) == pytest.approx((f / 100).mean())
    assert read("host_ms.replay", ctx) is None  # no such zone in the record
    assert read("host_ms.capture", ctx) is None  # the zone did not run
    # Idle [10, 20] lies under fill, [30, 40] under replay: 10 us each of 50.
    assert read("device_idle.fill", ctx) == pytest.approx(20.0)
    assert read("device_idle.replay", ctx) == pytest.approx(20.0)
    whole = 100 * (1 - ctx.trace.busy_us / ctx.trace.window_us)
    assert read("device_idle.fill", ctx) + read("device_idle.replay", ctx) <= whole + 1e-9


def test_innermost_pieces_of_nested_spans():
    spans = [(0.0, 50.0, "a"), (8.0, 25.0, "b"), (10.0, 12.0, "c"), (25.0, 45.0, "d")]
    pieces = records.innermost(spans)
    total = {}
    for s, e, n in pieces:
        total[n] = total.get(n, 0.0) + e - s
    assert total == {"a": 13.0, "b": 15.0, "c": 2.0, "d": 20.0}


def test_clock_fit_on_made_up_pairs():
    rng = np.random.default_rng(3)
    stamps = np.sort(rng.integers(0, 10**9, 40)).astype(np.int64)
    noise = rng.normal(0.0, 0.5, 40)
    starts = stamps * 1e-3 + 1234.5 + noise
    offset, residual = records.clock_fit(starts, stamps)
    assert offset == pytest.approx(1234.5, abs=0.5)
    assert np.allclose(residual, noise - np.median(noise))


@pytest.mark.parametrize("name", ["graph_pass_ms.Geometry", "graph_pass_ms_p95.SunShadow",
                                  "geometry.kept_share", "raster.drop_share",
                                  "host_ms.fill", "device_idle.replay"])
def test_nothing_to_read_gives_none(name):
    ctx = make_ctx(None, Trace([]))
    assert read(name, ctx) is None
    if name.startswith("graph_pass_ms"):  # the record's host clock is no device time
        host = make_ctx(make_rows(WARM + WINDOW + TRACED + CHAIN + 1, clock="perf_counter"))
        assert read(name, host) is None
