"""Procedural geometry, the standard test scene and the bindless-pressure
scene (port of arkoserenderer_tpu/assets/procedural.py, the parts the raster
frames use). Host numpy only; the same code gives the same pools as the
reference."""

from __future__ import annotations

import numpy as np

from arkoserenderer_torch.core.types import SceneLimits
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.lights import DirectionalLight
from arkoserenderer_torch.scene.scene import Material, MeshSegment, Scene, generate_tangents_uv


def make_plane(size: float = 1.0, uv_scale: float = 1.0) -> MeshSegment:
    """XZ plane centred at the origin, +Y normal, CCW seen from above."""
    s = size * 0.5
    positions = np.array([[-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s]], np.float32)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32) * uv_scale
    indices = np.array([0, 1, 2, 0, 2, 3], np.int32)
    tangents = generate_tangents_uv(positions, normals, uvs, indices)
    return MeshSegment(positions, normals, uvs, tangents, indices)


def make_box(extents=(1.0, 1.0, 1.0)) -> MeshSegment:
    """Axis-aligned box with per-face normals/uvs, CCW outward winding."""
    ex, ey, ez = [e * 0.5 for e in extents]
    axes = [  # (normal, up, right) per face
        ((0, 0, 1), (0, 1, 0), (1, 0, 0)),
        ((0, 0, -1), (0, 1, 0), (-1, 0, 0)),
        ((1, 0, 0), (0, 1, 0), (0, 0, -1)),
        ((-1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((0, 1, 0), (0, 0, -1), (1, 0, 0)),
        ((0, -1, 0), (0, 0, 1), (1, 0, 0)),
    ]
    half = np.array([ex, ey, ez], np.float32)
    positions, normals, uvs, indices = [], [], [], []
    for i, (n, u, r) in enumerate(axes):
        n = np.array(n, np.float32)
        u = np.array(u, np.float32)
        r = np.array(r, np.float32)
        c = n * half
        ru = r * half
        uu = u * half
        positions.extend([c - ru - uu, c + ru - uu, c + ru + uu, c - ru + uu])
        normals.extend([n] * 4)
        uvs.extend([[0, 1], [1, 1], [1, 0], [0, 0]])
        b = 4 * i
        indices.extend([b, b + 1, b + 2, b, b + 2, b + 3])
    positions = np.array(positions, np.float32)
    normals = np.array(normals, np.float32)
    uvs = np.array(uvs, np.float32)
    indices = np.array(indices, np.int32)
    tangents = generate_tangents_uv(positions, normals, uvs, indices)
    return MeshSegment(positions, normals, uvs, tangents, indices)


def make_uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> MeshSegment:
    ring = np.linspace(0, np.pi, rings + 1)
    sect = np.linspace(0, 2 * np.pi, sectors + 1)
    rr, ss = np.meshgrid(ring, sect, indexing="ij")
    x = np.sin(rr) * np.cos(ss)
    y = np.cos(rr)
    z = np.sin(rr) * np.sin(ss)
    positions = (radius * np.stack([x, y, z], -1)).reshape(-1, 3).astype(np.float32)
    normals = (positions / radius).astype(np.float32)
    uvs = np.stack([ss / (2 * np.pi), rr / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    stride = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * stride + s
            b = a + stride
            idx.extend([a, a + 1, b, b, a + 1, b + 1])
    indices = np.array(idx, np.int32)
    tangents = generate_tangents_uv(positions, normals, uvs, indices)
    return MeshSegment(positions, normals, uvs, tangents, indices)


def checkerboard_texture(size: int = 64, squares: int = 8, c0=200, c1=60) -> np.ndarray:
    img = np.zeros((size, size, 4), np.uint8)
    q = size // squares
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy // q) + (xx // q)) % 2 == 0
    img[..., :3] = np.where(mask[..., None], c0, c1)
    img[..., 3] = 255
    return img


def gradient_env_map(height: int = 64, zenith=(0.35, 0.55, 0.9),
                     horizon=(0.8, 0.85, 0.95), ground=(0.25, 0.22, 0.2)) -> np.ndarray:
    """Sky gradient equirect env map (linear radiance, unit scale)."""
    width = height * 2
    v = np.linspace(0.0, 1.0, height)[:, None, None]  # 0 = up
    zen = np.array(zenith, np.float32)
    hor = np.array(horizon, np.float32)
    gnd = np.array(ground, np.float32)
    sky = zen + (hor - zen) * np.clip(v * 2, 0, 1) ** 1.5
    below = hor + (gnd - hor) * np.clip(v * 2 - 1, 0, 1) ** 0.5
    img = np.where(v < 0.5, sky, below)
    return np.broadcast_to(img, (height, width, 3)).astype(np.float32)


def build_test_scene(
    limits: SceneLimits | None = None,
    viewport: tuple[int, int] = (256, 256),
    n_spheres: int = 3,
) -> tuple[Scene, Camera]:
    """The standard small test scene: checkered floor, spheres of varying
    roughness/metalness, one box, sunlight + sky."""
    lim = limits or SceneLimits(
        max_vertices=1 << 15, max_indices=3 << 15, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 19,
    )
    scene = Scene(limits=lim)

    checker = scene.add_texture(checkerboard_texture(128, 16), srgb=True)
    floor_mat = scene.add_material(Material(base_color_tex=checker, roughness_factor=0.8))
    floor = make_plane(size=20.0, uv_scale=10.0)
    floor.material = floor_mat
    fid = scene.add_segment(floor)
    scene.add_instance(fid, np.eye(4, dtype=np.float32))

    for i in range(n_spheres):
        f = i / max(n_spheres - 1, 1)
        mat = scene.add_material(
            Material(
                base_color_factor=np.array([0.8, 0.3 + 0.5 * f, 0.25, 1.0], np.float32),
                roughness_factor=0.15 + 0.7 * f,
                metallic_factor=1.0 if i % 2 else 0.0,
            )
        )
        seg = make_uv_sphere(0.6, rings=12, sectors=24)
        seg.material = mat
        sid = scene.add_segment(seg)
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (-2.0 + 2.0 * i, 0.6, 0.0)
        scene.add_instance(sid, w)

    box_mat = scene.add_material(
        Material(base_color_factor=np.array([0.3, 0.45, 0.8, 1.0], np.float32),
                 roughness_factor=0.4)
    )
    box = make_box((1.0, 1.4, 1.0))
    box.material = box_mat
    bid = scene.add_segment(box)
    wb = np.eye(4, dtype=np.float32)
    wb[:3, 3] = (0.0, 0.7, -2.2)
    scene.add_instance(bid, wb)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0

    cam = Camera(viewport=viewport)
    cam.look_at((4.0, 2.5, 5.0), (0.0, 0.6, -0.5))
    cam.focus_depth = 6.0
    return scene, cam


def _variety_textures(scene: Scene, n_textures: int, rng) -> tuple:
    """n_textures distinct base-colour chains (checker, stripes or rings with
    a scale and hue each) plus metallic-roughness and emissive chains for
    every third one. Returns (tex_ids, mr_tex_ids, emi_tex_ids)."""
    tex_ids = []
    mr_tex_ids = []
    emi_tex_ids = []
    for i in range(n_textures):
        size = 64
        sq = int(rng.integers(2, 16))
        hue = rng.random(3) * 0.8 + 0.2
        c0 = (hue * 220).astype(np.uint8)
        c1 = (hue * 70).astype(np.uint8)
        img = np.zeros((size, size, 4), np.uint8)
        q = max(size // sq, 1)
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        if i % 3 == 1:    # diagonal stripes
            mask = ((yy + xx) // q) % 2 == 0
        elif i % 3 == 2:  # rings
            r = np.sqrt((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
            mask = (r // q) % 2 == 0
        else:             # checker
            mask = ((yy // q) + (xx // q)) % 2 == 0
        img[..., :3] = np.where(mask[..., None], c0, c1)
        img[..., 3] = 255
        tex_ids.append(scene.add_texture(img, srgb=True))
        if i % 3 == 0:
            mr = np.zeros((32, 32, 4), np.uint8)
            mr[..., 1] = (rng.random((32, 32)) * 255).astype(np.uint8)  # rough
            mr[..., 2] = 255 if i % 6 == 0 else 0                       # metal
            mr[..., 3] = 255
            mr_tex_ids.append(scene.add_texture(mr, srgb=False))
            em = np.zeros((16, 16, 4), np.uint8)
            em[..., :3] = (hue * 255 * (((yy[:16, :16] // 4) % 2) == 0)[..., None]).astype(np.uint8)
            em[..., 3] = 255
            emi_tex_ids.append(scene.add_texture(em, srgb=True))
    return tex_ids, mr_tex_ids, emi_tex_ids


def build_bindless_scene(
    n_materials: int = 256,
    n_textures: int = 64,
    viewport: tuple[int, int] = (256, 256),
) -> tuple[Scene, Camera]:
    """Bindless-pressure scene: a grid of spheres where every instance has
    its own material, and the materials cycle through ``n_textures`` distinct
    texture chains, so neighbouring pixels routinely fetch from different
    chains. A third of the materials also bind a metallic-roughness and an
    emissive texture."""
    side = int(np.ceil(np.sqrt(n_materials)))
    spacing = 1.6
    extent = side * spacing
    lim = SceneLimits(
        max_vertices=max(1 << 16, 160 * n_materials + 8192),
        max_indices=max(3 << 16, 3 * (240 * n_materials + 8192)),
        max_drawables=max(64, n_materials + 8),
        max_materials=max(64, n_materials + 8),
        max_textures=max(64, 3 * n_textures + 8),
        texture_pool_texels=1 << 22,
    )
    scene = Scene(limits=lim)

    rng = np.random.default_rng(99)
    tex_ids, mr_tex_ids, emi_tex_ids = _variety_textures(scene, n_textures, rng)

    floor_mat = scene.add_material(Material(base_color_tex=tex_ids[0], roughness_factor=0.9))
    floor = make_plane(size=extent * 1.2, uv_scale=extent / 2)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    proto = make_uv_sphere(0.55, rings=8, sectors=12)
    for i in range(n_materials):
        m = Material(
            base_color_factor=np.array([*(0.4 + 0.6 * rng.random(3)), 1.0], np.float32),
            roughness_factor=float(0.15 + 0.8 * rng.random()),
            metallic_factor=float(rng.random() < 0.3),
            base_color_tex=tex_ids[i % n_textures],
        )
        if i % 3 == 0 and mr_tex_ids:
            m.mr_tex = mr_tex_ids[(i // 3) % len(mr_tex_ids)]
            m.emissive_tex = emi_tex_ids[(i // 3) % len(emi_tex_ids)]
            m.emissive_factor = np.full(3, 2000.0, np.float32)
        mid = scene.add_material(m)
        seg = MeshSegment(
            positions=proto.positions, normals=proto.normals, uvs=proto.uvs,
            indices=proto.indices, material=mid, tangents=proto.tangents,
        )
        sid = scene.add_segment(seg)
        gx, gz = i % side, i // side
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = ((gx - side / 2 + 0.5) * spacing, 0.75, (gz - side / 2 + 0.5) * spacing)
        scene.add_instance(sid, w)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0
    cam = Camera(viewport=viewport)
    cam.look_at((extent * 0.10, 5.0, extent * 0.16), (0.0, 0.4, 0.0))
    return scene, cam
