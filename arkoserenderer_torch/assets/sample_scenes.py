"""Real-asset sample scenes (port of arkoserenderer_tpu/assets/sample_scenes.py).

The DamagedHelmet glTF sample (Khronos glTF-Sample-Models, CC-BY "Battle
Damaged Sci-fi Helmet" by theblueturtle_) is vendored under
``<repo>/assets/sample/DamagedHelmet``, and ``find_sample`` reads only that
copy: the reference's fallback to an outside checkout of the original
renderer is dropped, as no machine this package runs on has one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from arkoserenderer_torch.assets.gltf import load_gltf
from arkoserenderer_torch.assets.procedural import gradient_env_map, make_plane
from arkoserenderer_torch.core.types import SceneLimits
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.lights import DirectionalLight
from arkoserenderer_torch.scene.scene import Material, Scene

REPO_SAMPLES = Path(__file__).resolve().parents[2] / "assets" / "sample"


def find_sample(name: str) -> Path:
    """The directory of a sample asset in the repository's copy."""
    p = REPO_SAMPLES / name
    if not p.is_dir():
        raise FileNotFoundError(f"sample asset '{name}' not found under {REPO_SAMPLES}")
    return p


def build_helmet_scene(
    n_grid: int = 6,
    viewport: tuple[int, int] = (1920, 1080),
    max_texture_size: int = 1024,
) -> tuple[Scene, Camera]:
    """A grid of n_grid x n_grid instanced DamagedHelmets over a ground
    plane. At 6x6 it draws 556,272 helmet triangles (36 x 15,452) with the
    helmet's five textures (albedo, normal, metallic-roughness, emissive,
    ambient occlusion), each clamped to ``max_texture_size``."""
    n_inst = n_grid * n_grid
    # The pool holds each instance's geometry: 36 helmets are ~524K vertices
    # and 1.67M indices.
    lim = SceneLimits(
        max_vertices=(n_inst * 14556 + 4096 + 0xFFF) & ~0xFFF,
        max_indices=(n_inst * 46356 + 4096 + 0xFFF) & ~0xFFF,
        max_drawables=max(64, n_inst + 8),
        max_materials=32, max_textures=32,
        # Five textures of at most 1024^2 with their mips: ~7M texels.
        texture_pool_texels=1 << 23,
    )
    scene = Scene(limits=lim)

    floor_mat = scene.add_material(Material(
        base_color_factor=np.array([0.45, 0.45, 0.48, 1.0], np.float32),
        roughness_factor=0.65,
    ))
    spacing = 2.6
    extent = n_grid * spacing
    floor = make_plane(size=extent * 1.6, uv_scale=extent / 4)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    load_gltf(scene, find_sample("DamagedHelmet") / "DamagedHelmet.gltf",
              max_texture_size=max_texture_size)

    # The import placed the helmet at the origin with its node's transform
    # (the Z-up -> Y-up rotation). Re-home it onto grid cell (0, 0), then
    # instance its segments over the rest of the grid: one geometry, n_inst
    # drawables.
    half = (n_grid - 1) * spacing * 0.5

    def cell_world(gx: int, gz: int) -> np.ndarray:
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (gx * spacing - half, 1.0, gz * spacing - half)
        return w

    cells = [(gx, gz) for gx in range(n_grid) for gz in range(n_grid)]
    imported = list(scene.instances[1:])  # everything after the floor
    for i, (sid, world, prev, lod) in enumerate(imported):
        scene.instances[1 + i] = (sid, (cell_world(*cells[0]) @ world).astype(np.float32),
                                  prev, lod)
    for gx, gz in cells[1:]:
        for sid, world, _prev, _lod in imported:
            scene.add_instance(sid, (cell_world(gx, gz) @ world).astype(np.float32))

    scene.sun = DirectionalLight(
        direction=np.array([-0.45, -1.0, -0.35], np.float32),
        illuminance_lux=95000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 4000.0

    cam = Camera(viewport=viewport)
    cam.look_at((half + 5.5, 4.5, half + 7.0), (0.0, 0.9, 0.0))
    cam.focus_depth = float(np.linalg.norm([half + 5.5, 3.6, half + 7.0]))
    return scene, cam


def build_helmet_golden_scene(res: int = 256) -> tuple[Scene, Camera]:
    """The helmet golden's scene (tests/test_golden.py's ``helmet`` case,
    tests/goldens/helmet.png): one DamagedHelmet, textures at most 256^2,
    under a sun with the gradient sky, seen from the front-right above."""
    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 18, max_indices=3 << 18, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 22,
    ))
    load_gltf(scene, find_sample("DamagedHelmet") / "DamagedHelmet.gltf", max_texture_size=256)
    scene.sun = DirectionalLight(
        direction=np.array([-0.5, -1.0, -0.6], np.float32),
        illuminance_lux=90000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 4000.0
    center, radius = scene.bounding_sphere()
    cam = Camera(viewport=(res, res))
    cam.look_at(center + np.array([radius * 0.4, radius * 0.5, radius * 2.0]), center)
    return scene, cam
