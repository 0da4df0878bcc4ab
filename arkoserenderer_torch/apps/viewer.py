"""Interactive live viewer: fly camera, picking, gizmo and timing table
(port of arkoserenderer_tpu/apps/viewer.py).

The interactive layer the reference builds with GLFW, ImGui and ImGuizmo
(Arkose.cpp's main loop, RenderPipeline.cpp:76-108's timing plot,
EditorGizmo.h:10-28, PickingNode.cpp, EditorScene.h's outliner), run
against the live renderer through the web System (``system/webviewer.py``):
open the printed URL, fly with WASD+QE, click a surface (or a hierarchy
row) to pick its instance, press 'g' to cycle the gizmo mode (translate,
rotate, scale: ImGuizmo's set) and move the selection with the arrows and
PgUp / PgDn; the page shows the frame's ms against the 16.667 ms budget and,
with ``--timings-every``, the per-pass table. It renders on the card unless
``main``'s ``device`` asks for the CPU. The frame's ms is the host's clock
around ``render_frame`` with the device synchronised before the clock
stops, so on the card it is the frame's time, not its launch time.

Usage:
  python -m arkoserenderer_torch.apps.viewer --port 8666 --frames 0   # 0 = run forever

``pipeline_config(args)``, ``make_renderer(args, device)``, ``run(args,
renderer, system, clock)`` (the frame loop over any System:
``ScriptedSystem`` replays a session with a fixed clock) and ``main(argv,
device, system, clock)`` are the pieces a caller can hold.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from arkoserenderer_torch.scene.editor import EditorScene, GizmoMode
from arkoserenderer_torch.system.system import ReplaySystem

TRANSLATE_KEYS = {
    "arrowleft": (-0.1, 0, 0), "arrowright": (0.1, 0, 0),
    "arrowup": (0, 0, -0.1), "arrowdown": (0, 0, 0.1),
    "pageup": (0, 0.1, 0), "pagedown": (0, -0.1, 0),
}
# Rotate: the arrows yaw and pitch, PgUp / PgDn roll (ImGuizmo's three rings).
ROTATE_KEYS = {
    "arrowleft": ((0, 1, 0), 0.05), "arrowright": ((0, 1, 0), -0.05),
    "arrowup": ((1, 0, 0), 0.05), "arrowdown": ((1, 0, 0), -0.05),
    "pageup": ((0, 0, 1), 0.05), "pagedown": ((0, 0, 1), -0.05),
}
SCALE_KEYS = {"arrowup": 1.03, "pageup": 1.03, "arrowdown": 1 / 1.03, "pagedown": 1 / 1.03}
MODE_ORDER = [GizmoMode.TRANSLATE, GizmoMode.ROTATE, GizmoMode.SCALE]


class ScriptedSystem(ReplaySystem):
    """A ReplaySystem with the web viewer's extras, for scripted sessions:
    a script entry (frame, "click", (x, y)) queues a pick and (frame,
    "select", (instance,)) a hierarchy select, as WebSystem's events do;
    every other entry calls an ``Input`` method. The published stats and
    hierarchy rows are kept (``stats``, ``hierarchy``)."""

    def __init__(self, script, **kw):
        web = [e for e in script if e[1] in ("click", "select")]
        super().__init__([e for e in script if e[1] not in ("click", "select")], **kw)
        self._web = sorted(web, key=lambda e: e[0])
        self._web_cursor = 0
        self.clicks: list[tuple[int, int]] = []
        self.selects: list[int] = []
        self.stats: dict = {}
        self.hierarchy: list = []

    def new_frame(self) -> bool:
        ok = super().new_frame()
        while self._web_cursor < len(self._web) and \
                self._web[self._web_cursor][0] <= self.frame_count:
            _, kind, args = self._web[self._web_cursor]
            if kind == "click":
                self.clicks.append((int(args[0]), int(args[1])))
            else:
                self.selects.append(int(args[0]))
            self._web_cursor += 1
        return ok

    def publish_stats(self, **kw) -> None:
        self.stats.update(kw)

    def publish_hierarchy(self, entries: list) -> None:
        self.hierarchy = entries

    def stop(self) -> None:
        pass


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--port", type=int, default=8666)
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = until Ctrl-C / quit)")
    p.add_argument("--timings-every", type=int, default=0,
                   help="refresh the per-pass ms table every N frames (slow; the card only)")
    p.add_argument("--hot-reload", action="store_true",
                   help="watch the port's sources; reload + reconstruct on save")
    return p


def pipeline_config(args):
    """The viewer's pipeline at ``--width`` x ``--height``: tile 8x16 with
    512 triangles a tile, a 512^2 sun map, TAA and Bloom."""
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig

    return PipelineConfig(
        width=args.width, height=args.height,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
        shadow_map_size=512,
    )


def make_renderer(args, device="cuda"):
    """The test scene in the viewer's pipeline, with the instance
    transforms uploaded before every frame (``dynamic_transforms``: the
    scene is dynamic, so the sun map is rastered every frame)."""
    from arkoserenderer_torch.assets.procedural import build_test_scene
    from arkoserenderer_torch.models.standard import Renderer

    scene, cam = build_test_scene(viewport=(args.width, args.height))
    return Renderer(scene, cam, pipeline_config(args), device=torch.device(device),
                    dynamic_transforms=True)


def hierarchy_entries(scene) -> list[dict]:
    """The scene-hierarchy panel's rows: instance, name, segment, material
    and position (rounded to mm) of every instance."""
    rows = []
    for i, (sid, w, *_rest) in enumerate(scene.instances):
        s = sid[0] if isinstance(sid, (list, tuple)) else sid
        seg = scene.segments[s]
        rows.append({
            "instance": i,
            "name": seg.name or f"segment {s}",
            "segment": int(s),
            "material": int(seg.material),
            "position": [round(float(v), 3) for v in w[:3, 3]],
        })
    return rows


def run(args, r, sysb, clock=None, watcher=None) -> None:
    """The frame loop over ``sysb`` (a System with the web viewer's
    ``clicks``, ``selects``, ``publish_stats``, ``publish_hierarchy`` and
    ``stop``): hot reload, the camera controller with ``dt`` from ``clock``
    (seconds; the host's clock by default) capped at 0.1 s, the gizmo keys,
    Esc, clicks into ``r.pick``, hierarchy selects, the frame, present and
    the stats, until the system says stop or ``--frames`` frames ran."""
    from arkoserenderer_torch.apps.showcase import sync_device
    from arkoserenderer_torch.scene.controllers import FpsCameraController

    clock = clock or time.perf_counter
    scene, cam = r.scene, r.camera
    editor = EditorScene(scene)
    controller = FpsCameraController(cam)
    sysb.publish_hierarchy(hierarchy_entries(scene))
    ema_ms = None
    n = 0
    last = clock()
    try:
        while sysb.new_frame():
            if watcher is not None and watcher.poll():
                r.reconstruct(rebuild_passes=True)
            now = clock()
            dt = min(now - last, 0.1)
            last = now
            controller.update(sysb.input, dt)

            if sysb.input.was_pressed("g"):
                editor.gizmo_mode = MODE_ORDER[(MODE_ORDER.index(editor.gizmo_mode) + 1) % 3]
            moved = False
            if editor.selected is not None:
                if editor.gizmo_mode is GizmoMode.TRANSLATE:
                    for key, delta in TRANSLATE_KEYS.items():
                        if sysb.input.is_down(key):
                            editor.translate(np.array(delta, np.float32))
                            moved = True
                elif editor.gizmo_mode is GizmoMode.ROTATE:
                    for key, (axis, ang) in ROTATE_KEYS.items():
                        if sysb.input.is_down(key):
                            editor.rotate(axis, ang)
                            moved = True
                else:
                    for key, f in SCALE_KEYS.items():
                        if sysb.input.is_down(key):
                            editor.scale(f)
                            moved = True
            if sysb.input.was_pressed("escape"):
                editor.selected = None
            for (x, y) in sysb.clicks:
                editor.select_from_pick(r.pick(x, y))
            sysb.clicks.clear()
            for inst in sysb.selects:
                editor.selected = inst if 0 <= inst < len(scene.instances) else None
            sysb.selects.clear()
            if moved:
                sysb.publish_hierarchy(hierarchy_entries(scene))

            t0 = time.perf_counter()
            img = r.render_frame()
            sync_device(r.device)
            ms = (time.perf_counter() - t0) * 1e3
            ema_ms = ms if ema_ms is None else 0.9 * ema_ms + 0.1 * ms
            sysb.present(img)

            stats = {
                "frame": n, "ms": ema_ms,
                "selected": -1 if editor.selected is None else int(editor.selected),
                "gizmo": editor.gizmo_mode.value,
            }
            if args.timings_every and n % args.timings_every == 0:
                from arkoserenderer_torch.utils.timing import time_passes

                t = time_passes(r.pipeline, r.state, r.scene_arrays,
                                cam.state(r.frame_index, r.device), iters=1)
                stats["timings"] = {k: float(v) for k, v in t.items()}
            sysb.publish_stats(**stats)

            n += 1
            if args.frames and n >= args.frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        sysb.stop()


def main(argv=None, device="cuda", system=None, clock=None) -> int:
    """Serve the viewer (``system``: the web System on ``--port`` unless
    given) on ``device`` until it stops; returns 0."""
    args = build_arg_parser().parse_args(argv)
    r = make_renderer(args, device)
    if system is None:
        from arkoserenderer_torch.system.webviewer import WebSystem

        system = WebSystem(port=args.port)
    system.create_window(args.width, args.height, "arkoserenderer_torch")
    if hasattr(system, "port"):
        print(f"viewer: http://127.0.0.1:{system.port}/  (Ctrl-C to stop)", flush=True)
    watcher = None
    if args.hot_reload:
        from arkoserenderer_torch.utils.hotreload import ModuleWatcher

        watcher = ModuleWatcher()
    run(args, r, system, clock, watcher)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
