"""Procedural geometry, the standard test scene, the animated test scene,
the culling-stress scene with its animation, the bindless-pressure scene,
the flagship scene and the truth harness's flat scene (port of
arkoserenderer_tpu/assets/procedural.py,
the parts the frames use, and of the reference bench's test_anim scene).
Scene building is host numpy: the same code gives the same pools as the
reference. ``make_stress_animator`` is the one function on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from arkoserenderer_torch.core.types import SceneLimits
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.lights import DirectionalLight, PointLight, SpotLight
from arkoserenderer_torch.scene.scene import (
    BLEND_TRANSLUCENT,
    Material,
    MeshSegment,
    Scene,
    generate_tangents_uv,
)


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


def add_glass_panes(scene: Scene, with_back: bool = True, alpha: float = 0.5) -> None:
    """Two translucent panes (thin boxes of ``alpha``) in front of the test
    scene's camera, as tests/test_translucent.py places them: a 1.6 red
    pane at (-2, 1, 2.2) and, with ``with_back``, a 2.4 blue pane 0.9
    further along the ray from the camera's (4, 2.5, 5) through it, which
    only depth peeling reveals."""
    front = scene.add_material(Material(
        base_color_factor=np.array([0.9, 0.3, 0.2, alpha], np.float32),
        roughness_factor=0.1, blend_mode=BLEND_TRANSLUCENT))
    back = scene.add_material(Material(
        base_color_factor=np.array([0.2, 0.4, 0.9, alpha], np.float32),
        roughness_factor=0.1, blend_mode=BLEND_TRANSLUCENT))
    cam_pos = np.array([4.0, 2.5, 5.0], np.float32)
    p_front = np.array([-2.0, 1.0, 2.2], np.float32)
    ray = (p_front - cam_pos) / np.linalg.norm(p_front - cam_pos)
    panes = [(front, p_front, 1.6)] + ([(back, p_front + ray * 0.9, 2.4)] if with_back else [])
    for mat, pos, size in panes:
        pane = make_box((size, size, 0.05))
        pane.material = mat
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = pos
        scene.add_instance(scene.add_segment(pane), w)


def build_anim_scene(viewport: tuple[int, int] = (256, 256)) -> tuple[Scene, Camera]:
    """The reference bench's ``test_anim`` scene: the test scene, a box
    skinned to a one-joint skeleton whose rest pose lifts it 0.6, and a UV
    sphere with one inflate morph target at weight 0.5. No clip moves the
    joint: the palette is the rest pose."""
    from arkoserenderer_torch.scene.animation import Skeleton

    scene, camera = build_test_scene(viewport=viewport)
    skel = scene.add_skeleton(Skeleton(
        parents=np.array([-1], np.int32),
        inverse_bind=np.eye(4, dtype=np.float32)[None],
        rest_translation=np.array([[0.0, 0.6, 0.0]], np.float32),
        rest_rotation=np.array([[0, 0, 0, 1]], np.float32),
        rest_scale=np.ones((1, 3), np.float32),
    ))
    box = make_box((0.7, 0.7, 0.7))
    box.material = scene.add_material(Material(
        base_color_factor=np.array([0.8, 0.6, 0.2, 1.0], np.float32)))
    nv = box.positions.shape[0]
    box.skeleton = skel
    box.skin_joints = np.zeros((nv, 4), np.int32)
    box.skin_weights = np.tile(np.array([1, 0, 0, 0], np.float32), (nv, 1))
    wb = np.eye(4, dtype=np.float32)
    wb[:3, 3] = (2.2, 0.0, 1.2)
    scene.add_instance(scene.add_segment(box), wb)
    sph = make_uv_sphere(0.5, rings=12, sectors=24)
    sph.material = box.material
    sph.morph_pos = sph.normals[None] * 0.4
    sph.morph_nrm = np.zeros((1, len(sph.normals), 3), np.float32)
    ws = np.eye(4, dtype=np.float32)
    ws[:3, 3] = (-2.6, 0.5, 1.5)
    scene.add_instance(scene.add_segment(sph), ws)
    scene.set_morph_weights(np.array([0.5], np.float32))
    return scene, camera


def build_stress_scene(
    n_instances: int = 4096,
    viewport: tuple[int, int] = (256, 256),
    limits: SceneLimits | None = None,
) -> tuple[Scene, Camera]:
    """Culling stress scene: a grid of ``n_instances`` cells over a floor,
    each one sphere with a two-level LOD chain (192 triangles near, 48 far,
    switching at 14 units), animated by ``animate_stress_scene`` on the
    host or ``make_stress_animator`` in the frame."""
    side = int(np.ceil(np.sqrt(n_instances)))
    spacing = 2.0
    extent = side * spacing
    lim = limits or SceneLimits(
        max_vertices=max(1 << 15, 160 * n_instances + 4096),
        max_indices=max(3 << 15, 3 * (240 * n_instances + 4096)),
        max_drawables=max(64, 2 * n_instances + 8),
        max_materials=32, max_textures=32, texture_pool_texels=1 << 19,
    )
    scene = Scene(limits=lim)

    checker = scene.add_texture(checkerboard_texture(64, 8), srgb=True)
    floor_mat = scene.add_material(Material(base_color_tex=checker, roughness_factor=0.85))
    floor = make_plane(size=extent * 1.2, uv_scale=extent / 4)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    body_mat = scene.add_material(Material(
        base_color_factor=np.array([0.75, 0.33, 0.21, 1.0], np.float32),
        roughness_factor=0.35, metallic_factor=1.0,
    ))
    body = make_uv_sphere(0.55, rings=8, sectors=12)
    body.material = body_mat
    sid = scene.add_segment(body)
    body_far = make_uv_sphere(0.55, rings=4, sectors=6)
    body_far.material = body_mat
    sid_far = scene.add_segment(body_far)
    lod_switch = 14.0 * spacing / 2.0

    rng = np.random.default_rng(1234)
    phases = rng.uniform(0, 2 * np.pi, n_instances).astype(np.float32)
    for i in range(n_instances):
        gx, gz = i % side, i // side
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = ((gx - side / 2 + 0.5) * spacing, 0.8, (gz - side / 2 + 0.5) * spacing)
        scene.add_instance_lods([sid, sid_far], w, distances=[lod_switch])
    scene._stress = ((sid, sid_far), side, spacing, phases)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0

    cam = Camera(viewport=viewport)
    cam.look_at((extent * 0.08, 4.0, extent * 0.12), (0.0, 0.5, 0.0))
    return scene, cam


def _stress_instances(scene: Scene) -> tuple[list[int], np.ndarray]:
    """The animated instances' ids and their phases (each grid cell's LOD
    levels share its phase)."""
    sids, _side, _spacing, phases = scene._stress
    idxs = [i for i, it in enumerate(scene.instances) if it[0] in sids]
    ph = phases[(np.arange(len(idxs)) // len(sids)) % len(phases)]
    return idxs, ph


def animate_stress_scene(scene: Scene, t: float) -> None:
    """Host animation of the stress grid at time ``t``: each cell spins
    about Y and bobs, and each moved instance keeps the transform it had as
    its previous one. Follow with ``Scene.update_instance_transforms`` (a Renderer with
    ``dynamic_transforms=True`` calls it before each frame)."""
    idxs, ph = _stress_instances(scene)
    c = np.cos(t + ph)
    s = np.sin(t + ph)
    bob = 0.8 + 0.35 * np.sin(2.0 * t + ph)
    w = np.stack([scene.instances[i][1] for i in idxs]).astype(np.float32)
    w[:, 0, 0] = c
    w[:, 0, 2] = s
    w[:, 2, 0] = -s
    w[:, 2, 2] = c
    w[:, 1, 3] = bob
    for k, i in enumerate(idxs):
        sid, old, _prev, band = scene.instances[i]
        scene.instances[i] = (sid, w[k], old, band)


def make_stress_animator(scene: Scene):
    """The frame's own animation of the stress grid: a function
    ``animate(arrays, frame_index, delta_time) -> arrays`` that writes the
    animated instances' rows of ``world``, ``prev_world`` (the pose one
    ``delta_time`` earlier), ``normal_mat`` and ``inst_sphere`` for the time
    ``t = frame_index * delta_time``, formed in float32 on the device as
    the reference forms it (a double ``t`` rounds ``t + phase`` otherwise
    and gives another ``sin``); the frame index and delta time are the
    frame's 0-d tensors or host values. Its row constants are uploaded at
    the first call on a device.

    It writes into copies of those four pools and leaves ``arrays`` as the
    caller built it: the frame stays a function of (scene, frame index), so
    a frame rendered again, or two paths compared on one scene, see the
    same input. The copies are 1.5 MB a frame at 8,200 drawables."""
    idxs, ph = _stress_instances(scene)
    n = len(idxs)
    base = idxs[0]
    if idxs != list(range(base, base + n)):
        raise ValueError("the animated instances must be contiguous")
    w0 = np.stack([np.asarray(scene.instances[i][1], np.float32) for i in idxs])
    radii = np.array([scene._segment_bounds(scene.instances[i][0])[1] for i in idxs],
                     np.float32)
    host = {"ph": ph.astype(np.float32), "tx": w0[:, 0, 3].copy(), "tz": w0[:, 2, 3].copy(),
            "radii": radii}
    on_device: dict = {}

    def rows_at(k, t):
        c = torch.cos(k["ph"] + t)
        s = torch.sin(k["ph"] + t)
        bob = 0.8 + 0.35 * torch.sin(k["ph"] + 2.0 * t)
        zero = torch.zeros_like(c)
        one = torch.ones_like(c)
        w = torch.stack([
            torch.stack([c, zero, s, k["tx"]], -1),
            torch.stack([zero, one, zero, bob], -1),
            torch.stack([-s, zero, c, k["tz"]], -1),
            torch.stack([zero, zero, zero, one], -1),
        ], dim=1)  # (n, 4, 4)
        return w, bob, c, s

    def animate(arrays, frame_index, delta_time):
        dev = arrays.world.device
        if dev not in on_device:
            on_device[dev] = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        k = on_device[dev]
        # t on the device, from the frame's scalars (host values are
        # uploaded): float32 as the host formed it, so the same bits.
        dt = torch.as_tensor(delta_time, dtype=torch.float32, device=dev)
        t = torch.as_tensor(frame_index, device=dev).to(torch.float32) * dt
        w, bob, c, s = rows_at(k, t)
        pw = rows_at(k, t - dt)[0]
        zero = torch.zeros_like(c)
        one = torch.ones_like(c)
        nm = torch.stack([  # a pure rotation is its own inverse-transpose
            torch.stack([c, zero, s], -1),
            torch.stack([zero, one, zero], -1),
            torch.stack([-s, zero, c], -1),
        ], dim=1)
        sph = torch.stack([k["tx"], bob, k["tz"], k["radii"]], -1)

        def put(pool, rows):
            out = pool.clone()
            out[base:base + n] = rows
            return out

        return arrays._replace(
            world=put(arrays.world, w), prev_world=put(arrays.prev_world, pw),
            normal_mat=put(arrays.normal_mat, nm), inst_sphere=put(arrays.inst_sphere, sph),
        )

    return animate


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


def build_flagship_scene(
    n_instances: int = 4096,
    n_materials: int = 256,
    n_textures: int = 64,
    viewport: tuple[int, int] = (1920, 1080),
) -> tuple[Scene, Camera]:
    """The representative-scale scene: ``n_instances`` spheres (192
    triangles each) over ``n_materials`` materials cycling ``n_textures``
    texture chains, on a textured floor, lit by the sun, two shadow-casting
    spots and a point light that casts no shadow. At 4,096 / 256 / 64:
    786,434 triangles. The random draws are the reference's, in its order,
    so both packages build the same pools."""
    side = int(np.ceil(np.sqrt(n_instances)))
    spacing = 2.0
    extent = side * spacing
    proto = make_uv_sphere(0.55, rings=8, sectors=12)
    vpp = proto.positions.shape[0]
    tpp = proto.indices.shape[0]
    lim = SceneLimits(
        max_vertices=vpp * n_instances + 8192,
        max_indices=tpp * n_instances + 32768,
        max_drawables=n_instances + 8,
        max_materials=n_materials + 8,
        max_textures=3 * n_textures + 8,
        texture_pool_texels=1 << 22,
    )
    scene = Scene(limits=lim)
    rng = np.random.default_rng(7)
    tex_ids, mr_tex_ids, emi_tex_ids = _variety_textures(scene, n_textures, rng)

    floor_mat = scene.add_material(Material(base_color_tex=tex_ids[0], roughness_factor=0.9))
    floor = make_plane(size=extent * 1.2, uv_scale=extent / 2)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    seg_ids = []
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
        seg_ids.append(scene.add_segment(seg))

    for i in range(n_instances):
        gx, gz = i % side, i // side
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (
            (gx - side / 2 + 0.5) * spacing,
            0.6 + 0.5 * ((gx * 7 + gz * 3) % 5) / 4.0,
            (gz - side / 2 + 0.5) * spacing,
        )
        scene.add_instance(seg_ids[i % n_materials], w)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    scene.spots.append(SpotLight(
        position=np.array([0.0, 10.0, 0.0], np.float32),
        direction=np.array([0.2, -1.0, 0.1], np.float32),
        luminous_intensity_cd=300000.0,
        outer_cone_angle=np.radians(45.0), inner_cone_angle=np.radians(30.0),
        cast_shadows=True,
    ))
    scene.spots.append(SpotLight(
        position=np.array([-extent * 0.2, 8.0, extent * 0.2], np.float32),
        direction=np.array([0.3, -1.0, -0.3], np.float32),
        luminous_intensity_cd=200000.0,
        outer_cone_angle=np.radians(40.0), inner_cone_angle=np.radians(25.0),
        cast_shadows=True,
    ))
    scene.points.append(PointLight(
        position=np.array([extent * 0.15, 4.0, -extent * 0.1], np.float32),
        luminous_intensity_cd=80000.0,
    ))
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0
    cam = Camera(viewport=viewport)
    cam.look_at((extent * 0.18, 7.0, extent * 0.26), (0.0, 0.5, 0.0))
    cam.focus_depth = extent * 0.25
    return scene, cam


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


def build_flat_test_scene(viewport: tuple[int, int] = (128, 128)) -> tuple[Scene, Camera]:
    """The truth harness's untextured scene: a floor, three diffuse spheres
    of rising roughness, a box and a clearcoat sphere, lit by the sun alone
    (no environment, no flat ambient). The path tracer's first-bounce NEE is
    then the raster's direct term, so the two must agree pixel by pixel."""
    lim = SceneLimits(
        max_vertices=1 << 15, max_indices=3 << 15, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 16,
    )
    scene = Scene(limits=lim)
    floor = make_plane(size=20.0)
    floor.material = scene.add_material(Material(
        base_color_factor=np.array([0.5, 0.5, 0.5, 1.0], np.float32), roughness_factor=0.8))
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))
    for i, rough in enumerate((0.2, 0.5, 0.9)):
        seg = make_uv_sphere(0.6, rings=24, sectors=48)
        seg.material = scene.add_material(Material(
            base_color_factor=np.array([0.8, 0.4, 0.3, 1.0], np.float32),
            roughness_factor=rough, metallic_factor=0.0))
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (-2.0 + 2.0 * i, 0.6, 0.0)
        scene.add_instance(scene.add_segment(seg), w)
    box = make_box((1.0, 1.4, 1.0))
    box.material = scene.add_material(Material(
        base_color_factor=np.array([0.3, 0.45, 0.8, 1.0], np.float32), roughness_factor=0.4))
    wb = np.eye(4, dtype=np.float32)
    wb[:3, 3] = (0.0, 0.7, -2.2)
    scene.add_instance(scene.add_segment(box), wb)
    # The clearcoat sphere: the Kelemen lobe must agree between the two.
    cc = make_uv_sphere(0.5, rings=24, sectors=48)
    cc.material = scene.add_material(Material(
        base_color_factor=np.array([0.55, 0.1, 0.1, 1.0], np.float32),
        roughness_factor=0.6, clearcoat=1.0, clearcoat_roughness=0.15))
    wc = np.eye(4, dtype=np.float32)
    wc[:3, 3] = (2.1, 0.5, 1.8)
    scene.add_instance(scene.add_segment(cc), wc)
    scene.sun = DirectionalLight(direction=np.array([0.4, -1.0, -0.3], np.float32),
                                 illuminance_lux=90000.0)
    scene.env_map = np.zeros((1, 2, 3), np.float32)
    scene.env_brightness = 0.0
    scene.ambient_lx = 0.0
    cam = Camera(viewport=viewport)
    cam.look_at((4.0, 2.5, 5.0), (0.0, 0.6, -0.5))
    return scene, cam
