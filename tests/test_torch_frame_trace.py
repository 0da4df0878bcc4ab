"""The port's frame record and frame-loop spans (``utils/profiling``), on
the CPU, where the record's timestamps are the host's clock.

* Each eager frame writes its row of the pipeline's record: the frame
  index, one non-decreasing timestamp a pass boundary in pass order, and
  the counters, which equal the culling's surviving triangles and the
  camera's bin counts recomputed from the same frame; the sun's are 0 in
  a frame that keeps the cached map.
* The ring wraps: frame R + 1 overwrites row 1.
* ``Renderer.render_frame`` under ``torch.profiler`` puts ``arkose.frame#<i>``
  and its children (``#<i>`` too), nested, into the exported trace;
  without a profiler only the zones' rolling averages and the record's
  host rows change, and the image is the same either way.
* A capture's span names the parts of the graph's key no kept graph had.
"""

import json

import numpy as np
import torch

from arkoserenderer_torch.assets.procedural import build_test_scene
from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.models.standard import Renderer
from arkoserenderer_torch.ops import raster
from arkoserenderer_torch.rendering.capture import KEY_PARTS, CompiledFrame
from arkoserenderer_torch.rendering.passes.geometry import camera_visible_triangles
from arkoserenderer_torch.rendering.pipeline import PipelineConfig, validate_frame
from arkoserenderer_torch.utils import profiling

torch.set_num_threads(2)

RES = 64
RCFG = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256)


def renderer(**kw):
    scene, cam = build_test_scene(viewport=(RES, RES), n_spheres=1)
    cfg = PipelineConfig(width=RES, height=RES, raster=RCFG, shadow_map_size=128)
    return Renderer(scene, cam, cfg, device="cpu", taa=True, bloom=False, **kw)


def test_eager_frames_write_their_rows_and_counters():
    r = renderer()
    names = [p.name for p in r.pipeline.passes]
    counted = []
    for _ in range(3):
        fi = r.frame_index
        cam = r.camera.state(fi, "cpu")  # the state the frame will use
        r.render_frame()
        s, st = r.scene_arrays, r.state
        kept, _ = camera_visible_triangles(s, cam.view_proj, cam.position,
                                           r.cfg.scene.has_meshlets)
        bins = raster.bin_triangles(st["vis.setup"], RES, RES, RCFG)
        counted.append((int(s.tri_valid.sum()), int(kept.sum()), int(st["vis.overflow"]),
                        int(bins.counts.sum() + bins.global_count)))
    rows = r.frame_records()
    assert rows["passes"] == names and rows["clock"] == "perf_counter"
    assert rows["frame_index"].tolist() == [0, 1, 2]
    assert rows["stamps_ns"].shape == (3, len(names) + 1)
    assert (np.diff(rows["stamps_ns"], axis=1) >= 0).all()
    assert (rows["stamps_ns"][1:, 0] >= rows["stamps_ns"][:-1, -1]).all()
    c = rows["counters"]
    assert set(c) == set(profiling.COUNTERS)
    got = list(zip(c["geometry.triangles"], c["geometry.kept"], c["raster.camera_dropped"],
                   c["raster.camera_binned"]))
    assert [tuple(map(int, g)) for g in got] == counted
    assert 0 < counted[0][1] <= counted[0][0]
    # A static scene rasters the sun at frame 0 only; later frames keep the map.
    assert c["raster.sun_binned"][0] > 0 and (c["raster.sun_binned"][1:] == 0).all()
    assert (c["raster.sun_dropped"][1:] == 0).all()


def test_ring_wraps(monkeypatch):
    monkeypatch.setattr(profiling, "RECORD_FRAMES", 4)
    r = renderer()
    record = r.pipeline.record
    r.pipeline.record = record
    for _ in range(6):
        r.render_frame()
    assert record.ring[1, 0] == 5 and record.ring[2, 0] == 2  # frame R + 1 took row 1
    assert r.frame_records()["frame_index"].tolist() == [2, 3, 4, 5]
    assert profiling.latest_frame_record() is record


def test_frame_spans_nest_in_a_cpu_trace(tmp_path):
    r = renderer(dynamic_transforms=True)
    r.render_frame()
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render_frame()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("arkose.")]
    by = {e["name"]: e for e in events}
    outer = by["arkose.frame#1"]
    children = {"arkose.frame.scene#1", "arkose.frame.camera#1"}
    assert children <= set(by) and set(by) <= children | {"arkose.frame#1"}
    for name in children:
        e = by[name]
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_without_a_profiler_only_the_averages_change():
    a, b = renderer(), renderer()
    for _ in range(2):
        a.render_frame()
    profiling.reset_zones()
    b.render_frame()
    assert set(profiling.zone_averages()) == {"arkose.frame", "arkose.frame.camera"}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        img = b.render_frame()
    assert len(profiling._ZONES["arkose.frame"]) == 2
    assert torch.equal(img, a.state["LDR"])
    # Each frame's zones left their milliseconds in its host row; zones that
    # did not run (no capture on the CPU) read NaN.
    host = b.frame_records()["host_ms"]
    assert set(host) == set(profiling.HOST_ZONES)
    frame, camera = host["arkose.frame"], host["arkose.frame.camera"]
    assert (np.isfinite(frame) & np.isfinite(camera)).all() and (camera <= frame).all()
    assert np.isnan(host["arkose.frame.fill"]).all()


def test_validate_frame_writes_a_whole_row():
    r = renderer()
    r.render_frame()
    cam = r.camera.state(7, "cpu")
    validate_frame(r.pipeline, dict(r.state), r.scene_arrays, cam, frame_index=7)
    rows = r.frame_records()
    assert rows["frame_index"].tolist() == [0, 7]
    stamps = rows["stamps_ns"][1]
    assert (np.diff(stamps) >= 0).all() and stamps[0] >= rows["stamps_ns"][0, -1]


def test_capture_names_the_new_parts_of_its_key():
    cf = CompiledFrame(renderer().pipeline)
    key = ("s", "sc", "cam", "in", False, (None, True))
    assert cf.new_parts(key) == "first graph"
    cf.graphs[key] = None
    assert cf.new_parts(key[:5] + ((None, False),)) == "new branches"
    assert cf.new_parts(("s2",) + key[1:4] + (True, key[5])) == "new state,chain"
    cf.graphs[("s2",) + key[1:]] = None
    assert cf.new_parts(("s2",) + key[1:4] + (True, key[5])) == "new chain"
    assert len(KEY_PARTS) == len(key)


def test_record_counts_add_and_reset_at_the_frame_start(monkeypatch):
    monkeypatch.setattr(profiling, "RECORD_FRAMES", 8)
    rec = profiling.FrameRecord(["A", "B"], "cpu")
    fi = torch.tensor(9, dtype=torch.int32)
    rec.stamp(fi, 0)
    rec.count(fi, "geometry.kept", torch.tensor(3))
    rec.count(fi, "geometry.kept", torch.tensor(4, dtype=torch.int32))
    rec.stamp(fi, 1)
    rec.stamp(fi, 2)
    rows = rec.rows()
    assert rows["frame_index"].tolist() == [9] and rows["counters"]["geometry.kept"][0] == 7
    rec.stamp(fi, 0)  # the same row's next frame starts from zero
    assert rec.rows()["counters"]["geometry.kept"][0] == 0
    # A host row belongs to the frame that wrote it last: frame 1 (row 1)
    # reads NaN once frame 9 has taken the row.
    rec.host_ms(9, "arkose.frame.fill", 2.5)
    assert rec.rows()["host_ms"]["arkose.frame.fill"].tolist() == [2.5]
    rec.host_ms(1, "arkose.frame.fill", 1.0)
    rec.host_ms(1, "arkose.frame.unknown", 1.0)  # not a zone of HOST_ZONES: dropped
    assert np.isnan(rec.rows()["host_ms"]["arkose.frame.fill"]).all()
    assert rec.ring.shape == (8, 1 + 2 + 1 + len(profiling.COUNTERS))
