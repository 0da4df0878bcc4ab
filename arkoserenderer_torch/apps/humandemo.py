"""HumanDemo app: the skin and subsurface-scattering showcase (port of
arkoserenderer_tpu/apps/humandemo.py).

A procedural bust: a head with a skin-tone texture and a ``subsurface``
material (which the SSSS pass reads), a neck and shoulders, 160 hair
strands rooted on the scalp (camera-facing ribbons, ``Scene.add_hair``),
a sun and a rim spot; then the forward pipeline with SSSS renders the
frames and the last is written as a PNG. It runs on the card unless
``main``'s ``device`` asks for the CPU.

Usage:
  python -m arkoserenderer_torch.apps.humandemo --frames 8 --out human.png
  python -m arkoserenderer_torch.apps.humandemo --no-ssss --no-hair --orbit

``build_human_scene(viewport, with_hair)``, ``make_renderer(args, scene,
cam, device)`` and ``main(argv, device)`` (which returns the Renderer) are
the pieces a caller can hold.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def skin_texture(size: int = 128) -> np.ndarray:
    """Procedural skin-tone albedo with subtle blotches (RGBA8)."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.array([225, 168, 144], np.float32)
    shade = np.array([188, 126, 110], np.float32)
    t = 0.5 + 0.5 * np.sin(6.28 * (yy * 1.3 + 0.2 * np.sin(6.28 * xx)))
    blotch = rng.normal(0, 1, (size // 8, size // 8))
    blotch = np.kron(blotch, np.ones((8, 8)))[:size, :size]
    t = np.clip(t + 0.08 * blotch, 0.0, 1.0)[..., None]
    rgb = base * (1 - t * 0.35) + shade * (t * 0.35)
    a = np.full((size, size, 1), 255.0)
    return np.clip(np.concatenate([rgb, a], -1), 0, 255).astype(np.uint8)


def hair_strands(n_strands: int = 160, pts_per: int = 6, seed: int = 3):
    """(points (n_strands * pts_per, 3), segments (n_strands,)): strands
    rooted on the upper scalp of the head at (0, 1.55, 0), combed outward
    and down."""
    rng = np.random.default_rng(seed)
    points, segs = [], []
    for _ in range(n_strands):
        theta = rng.uniform(0, 0.45 * np.pi)  # polar angle from +Y
        phi = rng.uniform(0, 2 * np.pi)
        root = np.array([0.5 * np.sin(theta) * np.cos(phi), 1.55 + 0.5 * np.cos(theta),
                         0.5 * np.sin(theta) * np.sin(phi)], np.float32)
        d = root - np.array([0.0, 1.55, 0.0], np.float32)
        d /= np.linalg.norm(d)
        p = root
        for k in range(pts_per):
            points.append(p)
            p = p + 0.035 * d + np.array([0, -0.02 * k, 0], np.float32)
        segs.append(pts_per - 1)
    return np.array(points, np.float32), np.array(segs, np.int64)


def build_human_scene(viewport, with_hair: bool = True):
    """(scene, camera) of the bust."""
    from arkoserenderer_torch.assets.procedural import (
        gradient_env_map,
        make_box,
        make_plane,
        make_uv_sphere,
    )
    from arkoserenderer_torch.core.types import SceneLimits
    from arkoserenderer_torch.scene.camera import Camera
    from arkoserenderer_torch.scene.lights import DirectionalLight, SpotLight
    from arkoserenderer_torch.scene.scene import Material, Scene

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 16, max_indices=3 << 16, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 20,
    ))
    floor_mat = scene.add_material(Material(
        base_color_factor=np.array([0.22, 0.22, 0.24, 1.0], np.float32), roughness_factor=0.9))
    floor = make_plane(size=8.0)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    skin = scene.add_material(Material(
        base_color_tex=scene.add_texture(skin_texture(), srgb=True), roughness_factor=0.55,
        subsurface=1.0))  # the SSSS pass's stencil

    def place(seg, material, y):
        seg.material = material
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (0.0, y, 0.0)
        scene.add_instance(scene.add_segment(seg), w)

    place(make_uv_sphere(0.5, rings=24, sectors=48), skin, 1.55)  # head
    place(make_box((0.24, 0.3, 0.24)), skin, 1.15)                # neck
    shirt = scene.add_material(Material(
        base_color_factor=np.array([0.25, 0.33, 0.5, 1.0], np.float32), roughness_factor=0.8))
    place(make_box((0.9, 0.45, 0.4)), shirt, 0.8)                 # shoulders

    if with_hair:
        hair_mat = scene.add_material(Material(
            base_color_factor=np.array([0.12, 0.08, 0.05, 1.0], np.float32),
            roughness_factor=0.45))
        points, segs = hair_strands()
        scene.add_hair(points, segs, material=hair_mat, radius=0.004)

    scene.sun = DirectionalLight(direction=np.array([-0.5, -0.7, -0.4], np.float32),
                                 illuminance_lux=60000.0)
    # Rim spot from behind-left.
    scene.spots.append(SpotLight(
        position=np.array([-1.6, 2.2, -1.8], np.float32),
        direction=np.array([0.55, -0.35, 0.75], np.float32),
        luminous_intensity_cd=250000.0, outer_cone_angle=np.radians(40.0)))
    scene.set_env_map(gradient_env_map(32), brightness=7000.0)
    scene.ambient_lx = 5000.0

    cam = Camera(viewport=viewport)
    cam.look_at((0.9, 1.65, 1.6), (0.0, 1.4, 0.0))
    cam.focus_depth = 2.0
    return scene, cam


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", type=str,
                   default=os.path.join(tempfile.gettempdir(), "arkose_torch_human.png"))
    p.add_argument("--no-ssss", action="store_true")
    p.add_argument("--no-hair", action="store_true")
    p.add_argument("--orbit", action="store_true", help="orbit the camera")
    return p


def make_renderer(args, scene, cam, device="cuda"):
    """The app's Renderer: tile 8x16 with 512 triangles a tile, a 1024^2
    sun map, SSSS unless ``--no-ssss``. (The reference also passes
    ``RasterConfig(bin_chunk=1024)``; nothing reads ``bin_chunk`` and the
    port's RasterConfig has no such field, so it is left out.)"""
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig

    cfg = PipelineConfig(width=args.width, height=args.height,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
                         shadow_map_size=1024)
    return Renderer(scene, cam, cfg, device=device, ssss=not args.no_ssss)


def orbit(cam, i: int, frames: int) -> None:
    """``--orbit``'s camera for frame ``i`` of ``frames``."""
    a = 0.4 * i / max(frames - 1, 1)
    cam.look_at((1.8 * np.sin(a + 0.5), 1.65, 1.8 * np.cos(a + 0.5)), (0.0, 1.4, 0.0))


def main(argv=None, device="cuda"):
    """Run the app with ``argv`` on ``device``; returns the Renderer."""
    from arkoserenderer_torch.utils.imageio import save_png

    args = build_arg_parser().parse_args(argv)
    device = torch.device(device)
    scene, cam = build_human_scene((args.width, args.height), with_hair=not args.no_hair)
    r = make_renderer(args, scene, cam, device)
    t0 = time.perf_counter()
    img = None
    for i in range(args.frames):
        if args.orbit:
            orbit(cam, i, args.frames)
        img = r.render_frame()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / max(args.frames, 1) * 1e3
    save_png(args.out, img.cpu().numpy())
    print(f"{args.frames} frames @ {ms:.2f} ms/frame -> {args.out}")
    return r


if __name__ == "__main__":
    main()
