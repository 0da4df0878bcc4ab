"""The port's live viewer (``arkoserenderer_torch/apps/viewer.py``) as a
whole on the CPU, against the JAX package.

* A scripted session at 96^2 with a fixed ``dt``: fly (WASD + a mouse
  move), a pick by click, a hierarchy select, the gizmo cycled through
  translate, rotate and scale with the selection moved in each mode, Esc.
  The port runs it through its viewer loop (``viewer.run`` over a
  ``ScriptedSystem``); the JAX package runs the same script through its
  ``Renderer``, ``EditorScene``, ``FpsCameraController`` and
  ``ReplaySystem``, with the reference loop's steps
  (``arkoserenderer_tpu/apps/viewer.py:102-161``) written out below. The
  instance transforms (world and previous world), the camera's position
  and orientation and the editor's selection and gizmo mode are equal bit
  for bit after the session; the last LDR frame is within the goldens'
  bound of JAX's (mean abs diff < 1.5 of 255, under 0.5 % of values off by
  more than 24: tests/test_golden.py).
* Physics committed each frame into ``Renderer(dynamic_transforms=True)``
  in both packages (``tests/test_system_physics.py:109-143``'s check): the
  bodies equal bit for bit, the frames within the goldens' bound, the
  moved world transforms on the device equal to the host's, and the
  vertex and index pools not uploaded again.
* ``reconstruct(rebuild_passes=True)`` (the hot-reload path) keeps
  ``TAAHistory`` bit for bit, and the frames after it equal a twin's that
  was never reconstructed.
* The HTTP roundtrip of ``tests/test_apps.py:143-225`` on the port's
  ``viewer.main`` with ``device="cpu"`` and fewer frames.
"""

import itertools
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import torch

from arkoserenderer_torch.apps import viewer
from arkoserenderer_torch.utils.imageio import decode_png, to_u8

torch.set_num_threads(2)

SIZE = 96
DT = 1 / 60.0
FRAMES = 10
# (frame, method, args): Input methods, and the web viewer's click and
# select events. The click lands on the middle sphere (instance 2); the
# select picks the box (instance 4).
SCRIPT = [
    (0, "push_key_down", ("w",)), (0, "push_mouse_move", (10.0, 5.0)),
    (1, "click", (48, 48)),
    (2, "push_key_up", ("w",)), (2, "push_key_down", ("ArrowRight",)),
    (3, "push_key_down", ("g",)), (3, "push_key_down", ("PageUp",)),
    (4, "push_key_up", ("g",)),
    (5, "push_key_down", ("g",)), (5, "push_mouse_move", (4.0, 9.0)),
    (6, "push_key_up", ("g",)), (6, "push_key_up", ("ArrowRight",)), (6, "select", (4,)),
    (7, "push_key_up", ("PageUp",)), (7, "push_key_down", ("ArrowUp",)),
    (8, "push_key_up", ("ArrowUp",)), (8, "push_key_down", ("g",)), (8, "push_key_down", ("d",)),
    (8, "push_key_down", ("PageDown",)),
    (9, "push_key_down", ("Escape",)),
]


def fixed_clock():
    """Seconds k * DT on the k-th call: the loop's dt is the difference of
    two calls, as from the host's clock."""
    ticks = itertools.count()
    return lambda: next(ticks) * DT


def assert_golden_close(ours, ref):
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 1.5, f"mean abs diff {diff.mean():.3f}"
    assert (diff > 24).mean() < 0.005, f"{(diff > 24).mean():.2%} values off by > 24"


def assert_instances_equal(t_scene, j_scene):
    assert len(t_scene.instances) == len(j_scene.instances)
    for (ts, tw, tp, tb), (js, jw, jp, _clip, jb) in zip(t_scene.instances, j_scene.instances):
        assert ts == js and tuple(tb) == tuple(jb)
        np.testing.assert_array_equal(tw, jw)
        assert (tp is None) == (jp is None)
        if tp is not None:
            np.testing.assert_array_equal(tp, jp)


def jax_session(script, frames: int, size: int):
    """The reference viewer's loop (apps/viewer.py:102-161) on the JAX
    package, over its ReplaySystem with the clicks and selects of
    ``script`` kept beside it; the clock as ``fixed_clock``'s."""
    from arkoserenderer_tpu.assets.procedural import build_test_scene
    from arkoserenderer_tpu.core.types import RasterConfig
    from arkoserenderer_tpu.models.standard import Renderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig
    from arkoserenderer_tpu.scene.controllers import FpsCameraController
    from arkoserenderer_tpu.scene.editor import EditorScene, GizmoMode
    from arkoserenderer_tpu.system.system import ReplaySystem

    scene, cam = build_test_scene(viewport=(size, size))
    cfg = PipelineConfig(width=size, height=size,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512,
                                             bin_chunk=1024),
                         shadow_map_size=512)
    r = Renderer(scene, cam, cfg, dynamic_transforms=True)
    sysb = ReplaySystem([e for e in script if e[1] not in ("click", "select")],
                        max_frames=frames)
    web = [e for e in script if e[1] in ("click", "select")]
    editor = EditorScene(scene)
    controller = FpsCameraController(cam)
    mode_order = [GizmoMode.TRANSLATE, GizmoMode.ROTATE, GizmoMode.SCALE]
    clock = fixed_clock()
    last = clock()
    img = None
    while sysb.new_frame():
        clicks = [a for f, k, a in web if k == "click" and f == sysb.frame_count]
        selects = [a[0] for f, k, a in web if k == "select" and f == sysb.frame_count]
        now = clock()
        dt = min(now - last, 0.1)
        last = now
        controller.update(sysb.input, dt)
        if sysb.input.was_pressed("g"):
            editor.gizmo_mode = mode_order[(mode_order.index(editor.gizmo_mode) + 1) % 3]
        if editor.selected is not None:
            if editor.gizmo_mode is GizmoMode.TRANSLATE:
                for key, delta in viewer.TRANSLATE_KEYS.items():
                    if sysb.input.is_down(key):
                        editor.translate(np.array(delta, np.float32))
            elif editor.gizmo_mode is GizmoMode.ROTATE:
                for key, (axis, ang) in viewer.ROTATE_KEYS.items():
                    if sysb.input.is_down(key):
                        editor.rotate(axis, ang)
            else:
                for key, f in viewer.SCALE_KEYS.items():
                    if sysb.input.is_down(key):
                        editor.scale(f)
        if sysb.input.was_pressed("escape"):
            editor.selected = None
        for (x, y) in clicks:
            editor.select_from_pick(r.pick(x, y))
        for inst in selects:
            editor.selected = inst if 0 <= inst < len(scene.instances) else None
        img = np.array(r.render_frame())
        sysb.present(img)
    return scene, cam, editor, img


def test_scripted_session_matches_jax():
    from arkoserenderer_tpu.apps import viewer as jviewer

    # The reference's key tables are the port's.
    src = open(jviewer.__file__).read()
    for key in ("arrowleft", "pageup", "1 / 1.03", "0.05"):
        assert key in src
    args = viewer.build_arg_parser().parse_args(
        ["--width", str(SIZE), "--height", str(SIZE), "--frames", str(FRAMES)])
    r = viewer.make_renderer(args, "cpu")
    sysb = viewer.ScriptedSystem(SCRIPT, max_frames=FRAMES)
    sysb.create_window(SIZE, SIZE, "viewer")
    viewer.run(args, r, sysb, clock=fixed_clock())
    assert sysb.frame_count == FRAMES and sysb.stats["frame"] == FRAMES - 1
    assert sysb.stats["ms"] > 0 and len(sysb.hierarchy) == len(r.scene.instances)

    j_scene, j_cam, j_editor, j_img = jax_session(SCRIPT, FRAMES, SIZE)
    assert_instances_equal(r.scene, j_scene)
    np.testing.assert_array_equal(r.camera.position, j_cam.position)
    np.testing.assert_array_equal(r.camera.orientation, j_cam.orientation)
    # Esc on the last frame cleared the selection; the gizmo went round to
    # translate; the sphere and the box moved in every mode.
    assert sysb.stats["selected"] == -1 and j_editor.selected is None
    assert sysb.stats["gizmo"] == j_editor.gizmo_mode.value == "translate"
    moved = [i for i, (_, w, p, _b) in enumerate(r.scene.instances)
             if p is not None and not np.array_equal(w, p)]
    assert moved == [2, 4], moved  # the sphere, then the box
    assert not np.array_equal(r.scene.instances[2][1][:3, :3], np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(r.scene_arrays.world[4].numpy(), r.scene.instances[4][1])
    ours = to_u8(sysb.last_frame.numpy())
    assert ours.shape == (SIZE, SIZE, 3) and ours.std() > 5
    assert_golden_close(ours, to_u8(j_img))


def physics_scene(pkg_name: str):
    """The test scene with one sphere (instance 1) and the box (instance 2)
    as bodies over the floor plane: the sphere dropped from 2.5 m, the box
    pushed by an impulse."""
    import importlib

    procedural = importlib.import_module(f"{pkg_name}.assets.procedural")
    scene, cam = procedural.build_test_scene(viewport=(SIZE, SIZE), n_spheres=1)
    return scene, cam


def test_physics_into_renderer_matches_jax():
    import arkoserenderer_torch.physics.backend as tphys
    import arkoserenderer_tpu.physics.backend as jphys
    from arkoserenderer_torch.core.types import RasterConfig as TRaster
    from arkoserenderer_torch.models.standard import Renderer as TRenderer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TConfig
    from arkoserenderer_tpu.core.types import RasterConfig as JRaster
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JConfig
    from test_torch_physics import assert_same_state, copy_bodies

    def cfg(Config, Raster):
        return Config(width=SIZE, height=SIZE,
                      raster=Raster(tile_h=8, tile_w=16, max_tris_per_tile=256),
                      shadow_map_size=128)

    jb = jphys.BuiltinPhysicsBackend()
    jb.add_static_plane((0, 1, 0), 0.0)
    sphere = jb.add_body(jphys.BodyDesc("sphere", np.array([0.6] * 3), mass=1.0,
                                        restitution=0.4), (-2.0, 2.5, 0.0))
    box = jb.add_body(jphys.BodyDesc("box", np.array([0.5, 0.7, 0.5]), mass=2.0),
                      (0.0, 0.7, -2.2))
    jb.apply_impulse(box, (5.0, 0.0, 1.0))
    tb = copy_bodies(jb)

    ts, tcam = physics_scene("arkoserenderer_torch")
    js, jcam = physics_scene("arkoserenderer_tpu")
    tr = TRenderer(ts, tcam, cfg(TConfig, TRaster), device="cpu", taa=False, bloom=False,
                   dynamic_transforms=True)
    jr = JRenderer(js, jcam, cfg(JConfig, JRaster), taa=False, bloom=False,
                   dynamic_transforms=True)
    first = to_u8(tr.render_frame().numpy())
    assert_golden_close(first, to_u8(np.array(jr.render_frame())))
    before = tr.scene_arrays
    tps, jps = tphys.PhysicsScene(tb, ts), jphys.PhysicsScene(jb, js)
    for ps in (tps, jps):
        ps.attach(sphere, 1)
        ps.attach(box, 2)
    for _ in range(3):
        for _ in range(6):
            tb.step(DT)
            jb.step(DT)
        assert_same_state(tb, jb)
        tps.commit()
        jps.commit()
        assert_instances_equal(ts, js)
        t_img = to_u8(tr.render_frame().numpy())
        j_img = to_u8(np.array(jr.render_frame()))
        assert_golden_close(t_img, j_img)
        for inst in (1, 2):
            np.testing.assert_array_equal(tr.scene_arrays.world[inst].numpy(),
                                          ts.instances[inst][1])
            np.testing.assert_array_equal(tr.scene_arrays.prev_world[inst].numpy(),
                                          ts.instances[inst][2])
    assert np.abs(t_img.astype(int) - first.astype(int)).max() > 12  # the bodies moved
    assert tr.scene_arrays.positions is before.positions
    assert tr.scene_arrays.indices is before.indices
    # The transform upload writes the instance rows into the scene's own
    # tensors (a captured frame reads them where it was captured).
    assert tr.scene_arrays.world is before.world


def test_reconstruct_keeps_taa_history():
    args = viewer.build_arg_parser().parse_args(["--width", "64", "--height", "64"])
    r, twin = viewer.make_renderer(args, "cpu"), viewer.make_renderer(args, "cpu")
    for _ in range(3):
        r.render_frame()
        twin.render_frame()
    history = r.state["TAAHistory"].clone()
    passes = r.pipeline.passes
    r.reconstruct(rebuild_passes=True)
    assert r.pipeline.passes is not passes and r.pipeline.passes[0] is not passes[0]
    assert torch.equal(r.state["TAAHistory"], history)
    for _ in range(2):
        assert torch.equal(r.render_frame(), twin.render_frame())


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_live_viewer_http_roundtrip():
    """``tests/test_apps.py::test_live_viewer_http_roundtrip`` on the port:
    frames served over HTTP, key, click, select and gizmo events taken, the
    loop rendering on until ``--frames``."""
    result = {}
    port = free_port()

    def run():
        try:
            result["rc"] = viewer.main(["--width", str(SIZE), "--height", str(SIZE),
                                        "--port", str(port), "--frames", "12"], device="cpu")
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            result["error"] = repr(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=60).read()

    def post(ev):
        rq = urllib.request.Request(base + "/event", data=json.dumps(ev).encode(), method="POST")
        urllib.request.urlopen(rq, timeout=30).read()

    png = b""
    for _ in range(240):
        try:
            png = get("/frame.png")
            if png:
                break
        except OSError:
            pass
        assert "error" not in result, result
        time.sleep(0.25)
    assert png[:4] == b"\x89PNG"
    assert decode_png(png).shape == (SIZE, SIZE, 3)
    assert b"viewer" in get("/")
    post({"type": "keydown", "key": "w"})
    post({"type": "click", "x": 48, "y": 60})
    hier = json.loads(get("/hierarchy"))
    assert len(hier) >= 2 and {"instance", "name", "segment"} <= set(hier[0])
    post({"type": "select", "instance": 0})
    post({"type": "keydown", "key": "g"})
    time.sleep(0.8)
    post({"type": "keyup", "key": "g"})
    post({"type": "keydown", "key": "ArrowUp"})
    time.sleep(0.5)
    post({"type": "keyup", "key": "ArrowUp"})
    # A CPU frame takes a second or more under load: poll for the frame
    # that took the events, where the reference's test sleeps a second.
    for _ in range(480):
        stats = json.loads(get("/stats"))
        if stats.get("selected") == 0 and stats.get("gizmo", "translate") != "translate":
            break
        assert "error" not in result, result
        time.sleep(0.25)
    assert stats["frame"] >= 1
    assert stats["ms"] > 0
    assert stats.get("selected") == 0
    assert stats.get("gizmo") in ("rotate", "scale")
    th.join(timeout=240)
    assert not th.is_alive()
    assert result.get("rc") == 0, result
