"""Mesh viewer: asset inspection, material edits and turntable or debug
renders (port of arkoserenderer_tpu/apps/meshviewer.py).

Prints the asset's structure (segments, materials, skeletons, animations),
drills into one segment (bounds, UV range, meshlet statistics, the
instances and LOD bands that use it), applies material edits and saves the
scene as a baked .npz, counts meshlets, and renders a turntable in the lit
pipeline or one G-buffer channel (``--view``, the DebugVisualize pass's
modes), or with ``--interactive`` serves an orbit view over HTTP (the web
System, ``system/webviewer.py``) until ``--frames`` frames ran (0: until
Ctrl-C). It renders on the card unless ``main``'s ``device`` asks for the
CPU.

Usage:
  python -m arkoserenderer_torch.apps.meshviewer model.gltf --frames 8
  python -m arkoserenderer_torch.apps.meshviewer a.npz --inspect-segment 0
  python -m arkoserenderer_torch.apps.meshviewer a.npz --view normal
  python -m arkoserenderer_torch.apps.meshviewer model.gltf --interactive --port 8667
  python -m arkoserenderer_torch.apps.meshviewer a.npz \\
      --set-material 1 roughness_factor=0.2 metallic_factor=1 --save b.npz
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def describe(scene) -> str:
    """The asset's segments, materials, skeletons and animations."""
    lines = []
    total_tris = sum(s.num_triangles for s in scene.segments)
    total_verts = sum(len(s.positions) for s in scene.segments)
    lines.append(
        f"segments: {len(scene.segments)}  vertices: {total_verts}  triangles: {total_tris}")
    for i, seg in enumerate(scene.segments):
        skin = f" skeleton={seg.skeleton}" if seg.skeleton >= 0 else ""
        lines.append(f"  [{i:3d}] verts={len(seg.positions):7d} tris={seg.num_triangles:7d} "
                     f"material={seg.material}{skin}")
    lines.append(f"materials: {len(scene.materials)}")
    for i, m in enumerate(scene.materials):
        lines.append(
            f"  [{i:3d}] base={np.round(m.base_color_factor, 2).tolist()} "
            f"rough={m.roughness_factor:.2f} metal={m.metallic_factor:.2f} "
            f"blend={m.blend_mode} tex(bc/n/mr)={m.base_color_tex}/{m.normal_tex}/{m.mr_tex}")
    if scene.skeletons:
        lines.append(f"skeletons: {len(scene.skeletons)} "
                     f"({[s.num_joints for s in scene.skeletons]} joints)")
    if scene.animations:
        lines.append("animations: " + ", ".join(
            f"{c.name or '?'} ({c.duration:.2f}s)" for c in scene.animations))
    return "\n".join(lines)


def inspect_segment(scene, idx: int) -> str:
    """One segment: bounds, counts, UV range, tangents and morphs, meshlet
    statistics, and the instances (with LOD bands) that use it."""
    from arkoserenderer_torch.assets.meshopt import build_meshlets

    seg = scene.segments[idx]
    lines = [f"segment [{idx}]"]
    lines.append(f"  bounds min {np.round(seg.positions.min(0), 3).tolist()}")
    lines.append(f"  bounds max {np.round(seg.positions.max(0), 3).tolist()}")
    lines.append(f"  verts {len(seg.positions)}  tris {seg.num_triangles}"
                 f"  material {seg.material}  skeleton {seg.skeleton}")
    uv = seg.uvs
    lines.append(f"  uv range [{uv.min():.3f}, {uv.max():.3f}]"
                 f"  tangents {'yes' if seg.tangents is not None else 'no'}"
                 f"  morphs {0 if seg.morph_pos is None else len(seg.morph_pos)}")
    ml = build_meshlets(seg.positions, seg.indices)
    if ml.count:
        counts = np.asarray(ml.tri_count[:ml.count])
        lines.append(f"  meshlets {ml.count} (tris/meshlet min {counts.min()}"
                     f" avg {counts.mean():.1f} max {counts.max()})")
    for i, (sid, _w, _pw, band) in enumerate(scene.instances):
        if sid == idx:
            far = "inf" if band[1] > 1e30 else f"{band[1]:.1f}"
            lines.append(f"  instance {i}: lod band [{band[0]:.1f}, {far})")
    return "\n".join(lines)


def apply_material_edits(scene, edits: list) -> None:
    """``--set-material IDX key=value ...``: set fields of material IDX
    (vectors as comma-separated floats)."""
    idx = int(edits[0])
    m = scene.materials[idx]
    for kv in edits[1:]:
        key, _, val = kv.partition("=")
        if not hasattr(m, key):
            raise ValueError(f"material has no field {key!r}")
        cur = getattr(m, key)
        if isinstance(cur, np.ndarray):
            vals = np.asarray([float(x) for x in val.split(",")], np.float32)
            if vals.shape != cur.shape:
                raise ValueError(f"{key} needs {cur.shape}")
            setattr(m, key, vals)
        elif isinstance(cur, bool):
            setattr(m, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(m, key, int(val))
        else:
            setattr(m, key, float(val))
    print(f"edited material {idx}")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("asset", help="glTF/GLB, .arkmsh or baked .npz")
    ap.add_argument("--frames", type=int, default=8, help="turntable frame count")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", type=str,
                    default=os.path.join(tempfile.gettempdir(), "meshviewer_{frame}.png"))
    ap.add_argument("--meshlets", action="store_true")
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--inspect-segment", type=int, default=None)
    ap.add_argument("--view", type=str, default=None,
                    help="debug channel render (normal/depth/instance/...)")
    ap.add_argument("--set-material", nargs="+", default=None, metavar="IDX KEY=VAL",
                    help="edit material fields (e.g. 1 roughness_factor=0.3)")
    ap.add_argument("--save", type=str, default=None,
                    help="write the (possibly edited) scene as baked .npz")
    ap.add_argument("--interactive", action="store_true",
                    help="serve an orbit view over HTTP")
    ap.add_argument("--port", type=int, default=8667)
    return ap


def load_asset(path: str):
    """A Scene with the asset: a baked .npz as saved, an .arkmsh's segments
    instanced at the origin, or a glTF's nodes (textures at most 256 a
    side)."""
    from arkoserenderer_torch.core.types import SceneLimits
    from arkoserenderer_torch.scene.scene import Scene

    limits = SceneLimits(max_vertices=1 << 19, max_indices=3 << 19, max_drawables=1024,
                         max_materials=256, max_textures=256, texture_pool_texels=1 << 23)
    src = str(path)
    if src.endswith(".npz"):
        from arkoserenderer_torch.assets.baked import load_baked

        return load_baked(src, limits=limits)
    scene = Scene(limits)
    if src.endswith(".arkmsh"):
        from arkoserenderer_torch.assets.ark import load_arkmsh

        for sid in load_arkmsh(scene, src, max_texture_size=256):
            scene.add_instance(sid, np.eye(4, dtype=np.float32))
    else:
        from arkoserenderer_torch.assets.gltf import load_gltf

        load_gltf(scene, src, max_texture_size=256)
    return scene


def make_renderer(args, scene, device="cuda"):
    """(renderer, camera, centre, radius): a sun and the gradient sky on the
    asset, tile 8x16 with 512 triangles a tile, a 512^2 sun map, no TAA;
    with ``--view`` the DebugVisualize pass last."""
    from arkoserenderer_torch.assets.procedural import gradient_env_map
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.passes.debugviz import DebugVisualizePass
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_torch.scene.camera import Camera
    from arkoserenderer_torch.scene.lights import DirectionalLight

    scene.sun = DirectionalLight(direction=np.array([0.4, -1.0, -0.3], np.float32))
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0
    cam = Camera(viewport=(args.size, args.size))
    center, radius = scene.bounding_sphere()
    cfg = PipelineConfig(width=args.size, height=args.size,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
                         shadow_map_size=512)
    cam.look_at(center + np.array([radius * 2.0, radius * 0.7, 0.0]), center)
    r = Renderer(scene, cam, cfg, device=device, taa=False)
    if args.view:
        r.pipeline.passes.append(DebugVisualizePass(args.view))
        r.pipeline.construct_all()
        r.state = r.pipeline.initial_state()
    return r, cam, center, radius


def turntable_eye(center, radius: float, f: int, frames: int) -> np.ndarray:
    angle = 2 * np.pi * f / frames
    return center + radius * 2.0 * np.array([np.cos(angle), 0.35, np.sin(angle)], np.float32)


def serve_orbit(args, r, center, radius) -> None:
    """``--interactive``: the web System on ``--port`` shows the asset
    orbiting at 0.4 rad/s of the host's clock, with the frame's ms (the
    device synchronised before the clock stops), until the page quits,
    Ctrl-C or ``--frames`` frames."""
    from arkoserenderer_torch.apps.showcase import sync_device
    from arkoserenderer_torch.system.webviewer import WebSystem

    sysb = WebSystem(port=args.port)
    sysb.create_window(args.size, args.size, "meshviewer")
    print(f"meshviewer: http://127.0.0.1:{sysb.port}/  (Ctrl-C to stop)", flush=True)
    t0 = time.perf_counter()
    n = 0
    try:
        while sysb.new_frame():
            angle = 0.4 * (time.perf_counter() - t0)
            eye = center + radius * 2.0 * np.array([np.cos(angle), 0.35, np.sin(angle)],
                                                   np.float32)
            r.camera.look_at(eye, center)
            ts = time.perf_counter()
            img = r.render_frame()
            sync_device(r.device)
            ms = (time.perf_counter() - ts) * 1e3
            sysb.present(img)
            sysb.publish_stats(frame=n, ms=ms)
            n += 1
            if args.frames and n >= args.frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        sysb.stop()


def main(argv=None, device="cuda"):
    """Run the viewer with ``argv`` on ``device``; returns the Renderer of
    the turntable or the orbit view (the Scene under ``--no-render``)."""
    args = build_arg_parser().parse_args(argv)
    scene = load_asset(args.asset)
    print(describe(scene))
    if args.inspect_segment is not None:
        print(inspect_segment(scene, args.inspect_segment))
    if args.set_material:
        apply_material_edits(scene, args.set_material)
    if args.save:
        from arkoserenderer_torch.assets.baked import save_baked

        save_baked(scene, args.save)
        print(f"saved {args.save}")
    if args.meshlets:
        from arkoserenderer_torch.assets.meshopt import build_meshlets

        total = sum(build_meshlets(s.positions, s.indices).count for s in scene.segments)
        print(f"meshlets: {total}")
    if args.no_render:
        return scene

    from arkoserenderer_torch.utils.imageio import save_png

    r, cam, center, radius = make_renderer(args, scene, torch.device(device))
    if args.interactive:
        serve_orbit(args, r, center, radius)
        return r
    for f in range(args.frames):
        cam.look_at(turntable_eye(center, radius, f, args.frames), center)
        save_png(args.out.format(frame=f), r.render_frame().cpu().numpy())
    print(f"rendered {args.frames} turntable frames -> {args.out}")
    return r


if __name__ == "__main__":
    main()
