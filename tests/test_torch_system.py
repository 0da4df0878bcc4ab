"""The port's system layer, camera controllers, editor, profiling zones and
hot reload against the JAX package's, on the same scripted inputs made
from a numpy seed.

* ``system/input.Input``: held keys, edges, mouse and scroll deltas and
  axes equal frame by frame;
* ``HeadlessSystem`` / ``ReplaySystem``: the same frames, and the PNGs
  written hold the same pixels (the port's present takes a tensor);
* ``FpsCameraController`` / ``MapCameraController``: camera position and
  orientation equal bit for bit after every frame of the same event script
  and ``dt`` sequence (host numpy on both sides);
* ``EditorScene`` translate / rotate / scale / delete and
  ``gizmo_axis_drag``: the instance transforms and the drag distances equal
  bit for bit;
* ``WebSystem``: the same events POSTed to each package's server give equal
  Input state, clicks and selects after ``new_frame()``; ``/stats`` and
  ``/hierarchy`` give equal JSON; ``/frame.png`` of the same uint8 image
  decodes to the same pixels (the bytes differ: the reference's PIL picks
  a PNG filter per row, the port writes filter 0 on every row); malformed
  events are dropped by the port's pump;
* ``utils/profiling``: the zones' rolling window and averages, and a CPU
  trace naming the zones;
* ``utils/hotreload.ModuleWatcher``: the two cases of ``tests/test_aux.py``,
  and a kernel wrapper reloaded that loads the library already built.
"""

import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from arkoserenderer_torch.core import mathx as tmx
from arkoserenderer_torch.scene.camera import Camera as TCamera
from arkoserenderer_torch.scene.controllers import FpsCameraController as TFps
from arkoserenderer_torch.scene.controllers import MapCameraController as TMap
from arkoserenderer_torch.scene.editor import EditorScene as TEditor
from arkoserenderer_torch.scene.editor import gizmo_axis_drag as t_drag
from arkoserenderer_torch.system.input import Input as TInput
from arkoserenderer_torch.system.system import HeadlessSystem as THeadless
from arkoserenderer_torch.system.system import ReplaySystem as TReplay
from arkoserenderer_torch.system.webviewer import WebSystem as TWeb
from arkoserenderer_torch.utils.imageio import decode_png, load_png
from arkoserenderer_tpu.core import mathx as jmx
from arkoserenderer_tpu.scene.camera import Camera as JCamera
from arkoserenderer_tpu.scene.controllers import FpsCameraController as JFps
from arkoserenderer_tpu.scene.controllers import MapCameraController as JMap
from arkoserenderer_tpu.scene.editor import EditorScene as JEditor
from arkoserenderer_tpu.scene.editor import gizmo_axis_drag as j_drag
from arkoserenderer_tpu.system.input import Input as JInput
from arkoserenderer_tpu.system.system import HeadlessSystem as JHeadless
from arkoserenderer_tpu.system.system import ReplaySystem as JReplay
from arkoserenderer_tpu.system.webviewer import WebSystem as JWeb

KEYS = ("w", "a", "s", "d", "q", "e", "W", "g", "mouse_left", "mouse_middle", "mouse_right",
        "ArrowUp", "Escape")


def random_script(seed: int, frames: int, per_frame: int = 3) -> list:
    """(frame, Input method, args) entries: key downs and ups (upper and
    lower case), mouse moves and scrolls."""
    rng = np.random.default_rng(seed)
    script = []
    for f in range(frames):
        for _ in range(int(rng.integers(0, per_frame + 1))):
            kind = int(rng.integers(0, 4))
            if kind == 0:
                script.append((f, "push_key_down", (KEYS[int(rng.integers(len(KEYS)))],)))
            elif kind == 1:
                script.append((f, "push_key_up", (KEYS[int(rng.integers(len(KEYS)))],)))
            elif kind == 2:
                x, y = rng.uniform(0, 200, 2)
                script.append((f, "push_mouse_move", (float(x), float(y))))
            else:
                script.append((f, "push_scroll", (float(rng.normal()),)))
    return script


def input_state(inp) -> tuple:
    return (sorted(inp._down), sorted(inp._pressed), sorted(inp._released),
            inp.mouse_pos.tobytes(), inp.mouse_delta.tobytes(), inp.scroll_delta,
            inp.gamepad_left.tobytes(), inp.gamepad_right.tobytes(),
            [inp.axis(p, n) for p, n in (("w", "s"), ("d", "a"), ("e", "q"))],
            [(inp.is_down(k), inp.was_pressed(k), inp.was_released(k)) for k in KEYS])


def test_input_matches_jax_frame_by_frame():
    ti, ji = TInput(), JInput()
    script = random_script(11, 40, per_frame=5)
    for f in range(40):
        ti.new_frame()
        ji.new_frame()
        assert input_state(ti) == input_state(ji)
        for _, method, args in (e for e in script if e[0] == f):
            getattr(ti, method)(*args)
            getattr(ji, method)(*args)
            assert input_state(ti) == input_state(ji)


def test_replay_and_headless_systems_match_jax(tmp_path):
    script = random_script(5, 8)
    rng = np.random.default_rng(3)
    frames = [rng.random((12, 16, 3)).astype(np.float32) for _ in range(8)]
    ts = TReplay(script, out_path=str(tmp_path / "t_{frame}.png"), max_frames=6)
    js = JReplay(script, out_path=str(tmp_path / "j_{frame}.png"), max_frames=6)
    ran = 0
    while True:
        t_ok, j_ok = ts.new_frame(), js.new_frame()
        assert t_ok == j_ok
        if not t_ok:
            break
        assert input_state(ts.input) == input_state(js.input)
        ts.present(torch.from_numpy(frames[ran]))
        js.present(frames[ran])
        ran += 1
    assert ran == ts.frame_count == js.frame_count == 6
    for f in range(6):
        ours = load_png(str(tmp_path / f"t_{f}.png"))
        np.testing.assert_array_equal(ours, load_png(str(tmp_path / f"j_{f}.png")))
        np.testing.assert_array_equal(ours, np.clip(frames[f] * 255 + 0.5, 0, 255).astype(np.uint8))
    th, jh = THeadless(), JHeadless()
    th.create_window(320, 200, "t")
    jh.create_window(320, 200, "j")
    assert th.framebuffer_size() == jh.framebuffer_size() == (320, 200)
    assert th.new_frame() and jh.new_frame()
    th.present(torch.zeros(2, 2, 3))
    assert th.frame_count == 1 and th.last_frame.shape == (2, 2, 3)


def test_np_quat_rotate_and_transform_points_h_match_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmx.np_quat_rotate(q, v), jmx.quat_rotate(q, v, xp=np))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    p = rng.normal(size=(9, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmx.np_transform_points_h(m, p),
                                  jmx.transform_points_h(m, p, xp=np))


def camera_pair(eye=(0.0, 1.5, 5.0), target=(0.0, 0.5, 0.0)):
    tc, jc = TCamera(viewport=(64, 48)), JCamera(viewport=(64, 48))
    tc.look_at(eye, target)
    jc.look_at(eye, target)
    return tc, jc


def assert_camera_equal(tc, jc):
    np.testing.assert_array_equal(tc.position, jc.position)
    np.testing.assert_array_equal(tc.orientation, jc.orientation)
    assert tc.position.dtype == jc.position.dtype and tc.orientation.dtype == jc.orientation.dtype


@pytest.mark.parametrize("kind", ["fps", "map"])
def test_camera_controllers_match_jax_bit_for_bit(kind):
    tc, jc = camera_pair()
    if kind == "fps":
        tctl, jctl = TFps(tc), JFps(jc)
    else:
        tctl = TMap(tc, focus=np.array([0.0, 0.5, 0.0], np.float32), distance=6.0)
        jctl = JMap(jc, focus=np.array([0.0, 0.5, 0.0], np.float32), distance=6.0)
    script = random_script(21 if kind == "fps" else 22, 60, per_frame=4)
    ti, ji = TInput(), JInput()
    dts = np.random.default_rng(4).uniform(1 / 240, 1 / 20, 60)
    for f in range(60):
        ti.new_frame()
        ji.new_frame()
        for _, method, args in (e for e in script if e[0] == f):
            getattr(ti, method)(*args)
            getattr(ji, method)(*args)
        tctl.update(ti, float(dts[f]))
        jctl.update(ji, float(dts[f]))
        assert_camera_equal(tc, jc)
    if kind == "map":
        np.testing.assert_array_equal(tctl.focus, jctl.focus)
        assert (tctl.distance, tctl.yaw, tctl.pitch) == (jctl.distance, jctl.yaw, jctl.pitch)
    else:
        np.testing.assert_array_equal(tctl._velocity, jctl._velocity)
        assert (tctl._yaw, tctl._pitch) == (jctl._yaw, jctl._pitch)
    assert not np.array_equal(tc.position, camera_pair()[0].position)


def assert_instances_equal(t_scene, j_scene):
    """The port's (sid, world, prev, band) against the reference's (sid,
    world, prev, clip, band): every field equal, bit for bit."""
    assert len(t_scene.instances) == len(j_scene.instances)
    for (ts, tw, tp, tb), (js, jw, jp, _clip, jb) in zip(t_scene.instances, j_scene.instances):
        assert ts == js and tuple(tb) == tuple(jb)
        np.testing.assert_array_equal(tw, jw)
        assert tw.dtype == np.asarray(jw).dtype
        assert (tp is None) == (jp is None)
        if tp is not None:
            np.testing.assert_array_equal(tp, jp)


def test_editor_and_gizmo_match_jax_bit_for_bit():
    from arkoserenderer_torch.assets.procedural import build_test_scene as t_build
    from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build

    ts, tcam = t_build(viewport=(96, 96), n_spheres=2)
    js, jcam = j_build(viewport=(96, 96), n_spheres=2)
    ted, jed = TEditor(ts), JEditor(js)
    assert ted.select_from_pick({"instance": -1}) is None is jed.select_from_pick({"instance": -1})
    assert ted.select_from_pick({"instance": 2}) == jed.select_from_pick({"instance": 2}) == 2
    rng = np.random.default_rng(17)
    for step in range(30):
        op = step % 3
        if op == 0:
            d = rng.normal(size=3).astype(np.float32)
            ted.translate(d)
            jed.translate(d)
        elif op == 1:
            axis, ang = rng.normal(size=3), float(rng.uniform(-1, 1))
            ted.rotate(axis, ang)
            jed.rotate(axis, ang)
        else:
            f = float(rng.uniform(0.9, 1.1))
            ted.scale(f)
            jed.scale(f)
        assert_instances_equal(ts, js)
        np.testing.assert_array_equal(ted.selected_transform(), jed.selected_transform())
    ted.selected = jed.selected = 1
    ted.delete_selected()
    jed.delete_selected()
    assert ted.selected is None is jed.selected
    assert_instances_equal(ts, js)
    with pytest.raises(ValueError):
        ted.translate((1, 0, 0))

    for _ in range(40):
        eye, target = rng.uniform(-8, 8, 3), rng.uniform(-1, 1, 3)
        tcam.look_at(eye, target)
        jcam.look_at(eye, target)
        assert_camera_equal(tcam, jcam)
        axis = rng.normal(size=3).astype(np.float32)
        obj = rng.normal(size=3).astype(np.float32)
        m0, m1 = rng.uniform(0, 96, 2), rng.uniform(0, 96, 2)
        assert t_drag(tcam, axis, obj, m0, m1) == j_drag(jcam, axis, obj, m0, m1)
    # Towards the camera: no movement on either side.
    tcam.look_at((0, 0, 10), (0, 0, 0))
    jcam.look_at((0, 0, 10), (0, 0, 0))
    z = np.array([0, 0, 1.0], np.float32)
    assert t_drag(tcam, z, np.zeros(3, np.float32), np.array([10, 10]), np.array([30, 10])) == \
        j_drag(jcam, z, np.zeros(3, np.float32), np.array([10, 10]), np.array([30, 10]))


def _post(base, ev):
    rq = urllib.request.Request(base + "/event", data=json.dumps(ev).encode(), method="POST")
    return urllib.request.urlopen(rq, timeout=30).read()


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=30).read()


def test_web_system_matches_jax():
    systems = (TWeb(port=0), JWeb(port=0))
    try:
        for s in systems:
            s.create_window(48, 32, "viewer")
        bases = [f"http://127.0.0.1:{s.port}" for s in systems]
        for b in bases:
            page = _get(b, "/")
            assert b"viewer" in page and b'width="48"' in page
            assert _get(b, "/frame.png") == b""  # no frame yet
        rng = np.random.default_rng(9)
        events = [{"type": "keydown", "key": "W"}, {"type": "keydown", "key": "ArrowUp"},
                  {"type": "click", "x": 12, "y": 7}, {"type": "select", "instance": 3},
                  {"type": "keyup", "key": "w"}, {"type": "nonsense"}, {"type": "keydown"},
                  {"type": "click", "x": "40"}]
        events += [{"type": "keydown" if rng.random() < 0.5 else "keyup",
                    "key": KEYS[int(rng.integers(len(KEYS)))]} for _ in range(12)]
        for batch in (events[:7], events[7:], []):
            for ev in batch:
                for b in bases:
                    _post(b, ev)
            # Raw bodies that are not JSON count as an empty event on both.
            for b in bases:
                rq = urllib.request.Request(b + "/event", data=b"{not json", method="POST")
                assert urllib.request.urlopen(rq, timeout=30).read() == b"{}"
            oks = [s.new_frame() for s in systems]
            assert oks == [True, True]
            assert input_state(systems[0].input) == input_state(systems[1].input)
            assert systems[0].clicks == systems[1].clicks
            assert systems[0].selects == systems[1].selects
        assert systems[0].clicks == [(12, 7), (40, 0)] and systems[0].selects == [3]

        rows = [{"instance": 0, "name": "floor", "segment": 0, "material": 1,
                 "position": [0.0, 0.0, 0.0]}]
        for s in systems:
            s.publish_stats(frame=4, ms=12.5, selected=2, gizmo="rotate",
                            timings={"<frame>": 3.25})
            s.publish_hierarchy(rows)
        assert json.loads(_get(bases[0], "/stats")) == json.loads(_get(bases[1], "/stats"))
        assert json.loads(_get(bases[0], "/hierarchy")) == json.loads(
            _get(bases[1], "/hierarchy")) == rows

        img = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        systems[0].present(torch.from_numpy(img))
        systems[1].present(img)
        pngs = [_get(b, "/frame.png") for b in bases]
        np.testing.assert_array_equal(decode_png(pngs[0]), decode_png(pngs[1]))
        np.testing.assert_array_equal(decode_png(pngs[0]), img)
        ldr = torch.from_numpy(rng.random((32, 48, 3)).astype(np.float32))
        systems[0].present(ldr)
        systems[1].present(ldr.numpy())
        np.testing.assert_array_equal(decode_png(_get(bases[0], "/frame.png")),
                                      decode_png(_get(bases[1], "/frame.png")))

        # Malformed events (a list body, a coordinate that is no number) are
        # dropped by the port's pump; the reference's raises on them.
        for body in (b"[1, 2]", json.dumps({"type": "click", "x": "left"}).encode(),
                     json.dumps({"type": "select", "instance": None}).encode()):
            rq = urllib.request.Request(bases[0] + "/event", data=body, method="POST")
            urllib.request.urlopen(rq, timeout=30).read()
        assert systems[0].new_frame() and systems[0].clicks[-1] == (40, 0)
        assert systems[0].selects == [3]

        for b in bases:
            _post(b, {"type": "quit"})
        assert [s.new_frame() for s in systems] == [False, False]
    finally:
        for s in systems:
            s.stop()


def test_profiling_zones_and_cpu_trace(tmp_path):
    """Zones nest: each "inner" zone (every other frame) lies within its
    "frame" zone, so its time is at most that frame's, whatever the
    scheduler does between the clock reads (the averages of the two
    windows cover different frames and need not be ordered)."""
    from arkoserenderer_torch.utils import profiling as tprof
    from arkoserenderer_tpu.utils import profiling as jprof

    for prof in (tprof, jprof):
        prof.reset_zones()
        n = prof.ZONE_WINDOW + 10
        for i in range(n):
            with prof.zone("frame"):
                if i % 2 == 0:
                    with prof.zone("inner"):
                        pass
        avg = prof.zone_averages()
        frames, inner = prof._ZONES["frame"], prof._ZONES["inner"]
        assert set(avg) == {"frame", "inner"} and min(avg.values()) >= 0
        assert avg["frame"] == sum(frames) / len(frames)
        assert avg["inner"] == sum(inner) / len(inner)
        assert len(frames) == prof.ZONE_WINDOW
        assert len(inner) == n // 2
        first = n - prof.ZONE_WINDOW  # the first frame the window keeps
        pairs = [(inner[k], frames[2 * k - first]) for k in range(len(inner)) if 2 * k >= first]
        assert len(pairs) == prof.ZONE_WINDOW // 2
        assert all(0 <= a <= b for a, b in pairs), pairs
        prof.reset_zones()
        assert prof.zone_averages() == {}
    assert tprof.ZONE_WINDOW == jprof.ZONE_WINDOW

    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir, device="cpu") as d:
        assert d == log_dir
        for _ in range(2):
            with tprof.zone("viewer frame"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    text = open(os.path.join(log_dir, files[0])).read()
    assert "viewer frame" in text and "aten::mm" in text
    assert len(tprof._ZONES["viewer frame"]) == 2
    tprof.reset_zones()


def _write_module(path, body: str, bump: float):
    path.write_text(body)
    os.utime(path, (time.time() + bump, time.time() + bump))


def test_module_watcher_reloads_changed_module(tmp_path):
    from arkoserenderer_torch.utils.hotreload import ModuleWatcher

    mod_file = tmp_path / "t_hot_mod_test.py"
    mod_file.write_text("def value():\n    return 1\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import t_hot_mod_test

        assert t_hot_mod_test.value() == 1
        w = ModuleWatcher(roots=[str(tmp_path)], poll_interval=0.0)
        assert w.poll() == []
        _write_module(mod_file, "def value():\n    return 2\n", 2)
        assert "t_hot_mod_test" in w.poll()
        assert t_hot_mod_test.value() == 2
        # The poll interval holds a second poll back.
        slow = ModuleWatcher(roots=[str(tmp_path)], poll_interval=3600.0)
        assert slow.poll() == []
        _write_module(mod_file, "def value():\n    return 5\n", 4)
        assert slow.poll() == [] and t_hot_mod_test.value() == 2
        # The default root is the port's package.
        import arkoserenderer_torch

        assert ModuleWatcher().roots == [os.path.dirname(arkoserenderer_torch.__file__)]
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("t_hot_mod_test", None)


def test_module_watcher_survives_broken_module(tmp_path, capsys):
    from arkoserenderer_torch.utils.hotreload import ModuleWatcher

    mod_file = tmp_path / "t_hot_mod_broken.py"
    mod_file.write_text("def value():\n    return 1\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import t_hot_mod_broken

        w = ModuleWatcher(roots=[str(tmp_path)], poll_interval=0.0)
        _write_module(mod_file, "def value(:\n", 2)
        assert w.poll() == []
        assert "t_hot_mod_broken failed" in capsys.readouterr().err
        assert t_hot_mod_broken.value() == 1
        _write_module(mod_file, "def value():\n    return 3\n", 4)
        assert "t_hot_mod_broken" in w.poll()
        assert t_hot_mod_broken.value() == 3
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("t_hot_mod_broken", None)


def test_reloaded_kernel_wrapper_loads_the_built_library(tmp_path, monkeypatch):
    """Reloading the raster wrapper's module resets its library handle; the
    next ``build_kernels()`` finds the library built for the same sources
    (its name hashes them) and loads it without running nvcc. A second
    instance of ``ops/raster_cuda.py`` is loaded under another name and its
    code run again in place, as ``importlib.reload`` does, so the package's
    own module is untouched; nvcc and the loader
    are stand-ins: the first build "compiles" by writing the files, the
    loader records what it opens."""
    import ctypes
    import importlib.util
    import subprocess

    from arkoserenderer_torch.ops import raster_cuda

    calls = {"nvcc": 0, "loaded": []}

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls["nvcc"] += 1
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return "", "ptxas info    : Used 32 registers\n"

    def fake_run(cmd, **kw):
        calls["nvcc"] += 1
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class FakeLib:
        def __init__(self, name):
            self._name = name
            calls["loaded"].append(name)
            for fn in ("raster_tiles_launch", "bvh_trace_launch", "bvh_trace_warps_per_sm",
                       "frame_stamp_launch", "frame_count_launch"):
                setattr(self, fn, type("Fn", (), {})())

    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    name = "t_raster_cuda_instance"
    spec = importlib.util.spec_from_file_location(name, raster_cuda.__file__)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, mod)
    spec.loader.exec_module(mod)

    def point_at_tmp(m):
        m.BUILD_DIR = tmp_path / "kernels"
        m._nvcc = lambda: "nvcc"

    point_at_tmp(mod)
    first = mod.build_kernels()
    n_sources = len(list(mod.CSRC.glob("*.cu")))
    assert calls["nvcc"] == n_sources + 1  # one compile a source, one link
    built = sorted(os.listdir(tmp_path / "kernels"))
    assert mod.build_kernels() is first  # the handle is kept

    spec.loader.exec_module(mod)  # what importlib.reload does to the module
    assert mod._lib is None and mod.rasterize_tiles_cuda.launches == 0
    point_at_tmp(mod)
    again = mod.build_kernels()
    assert calls["nvcc"] == n_sources + 1  # nothing compiled again
    assert again._name == first._name and calls["loaded"] == [first._name] * 2
    assert sorted(os.listdir(tmp_path / "kernels")) == built
    assert raster_cuda.BUILD_DIR != mod.BUILD_DIR  # the package's module untouched
