"""Streaming, the port against the JAX package: ``Scene.stream_instance``,
``stream_material``, ``stage_*`` and ``rendering/streaming.StreamingManager``
(the 12 cases of tests/test_streaming.py), and ``core/taskgraph`` (the
cases of tests/test_aux.py).

Both packages build the same scene and stream the same rows. Tolerances:
  * every SceneArrays field, after each stream and each tick, equals JAX's
    exactly (ints, bools and floats; the BVH after its refit too: the
    streamed rows are host numpy in both, and the refit's derivations give
    the same bits);
  * bytes a tick and the ticket states equal JAX's tick by tick;
  * a streamed frame (96^2) against JAX's streamed frame: the bound of
    test_torch_forward.py (2e-4 on all but 0.2 % of values, means within
    1e-5);
  * the streamed frame against the port's own rebuilt frame: 1e-5 (the
    reference's test_stream_matches_full_rebuild);
  * every pool tensor keeps its ``data_ptr()`` through every write.
"""

import numpy as np
import pytest
import torch

import arkoserenderer_torch.assets.procedural as tproc
import arkoserenderer_torch.scene.animation as tanim
import arkoserenderer_torch.scene.scene as tscene
import arkoserenderer_tpu.assets.procedural as jproc
import arkoserenderer_tpu.scene.animation as janim
import arkoserenderer_tpu.scene.scene as jscene
from arkoserenderer_torch import bridge
from arkoserenderer_torch.core import taskgraph as ttask
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import Renderer as TRenderer
from arkoserenderer_torch.rendering import streaming as tstream
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import Renderer as JRenderer
from arkoserenderer_tpu.rendering import streaming as jstream
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

torch.set_num_threads(2)

RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
SIZE = dict(width=96, height=96, shadow_map_size=128)
PKG = {"jax": (jproc, jscene), "torch": (tproc, tscene)}


def cfg(pkg):
    if pkg == "jax":
        return JPipelineConfig(raster=JRasterConfig(**RASTER), **SIZE)
    return TPipelineConfig(raster=TRasterConfig(**RASTER), **SIZE)


def renderer(pkg, scene, cam, **kw):
    kw = dict(taa=False, bloom=False, **kw)
    if pkg == "jax":
        return JRenderer(scene, cam, cfg(pkg), **kw)
    return TRenderer(scene, cam, cfg(pkg), device="cpu", **kw)


def frame(r) -> np.ndarray:
    out = r.render_frame()
    return out.numpy().copy() if isinstance(out, torch.Tensor) else np.array(out)


def translated(x, y, z):
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (x, y, z)
    return w


def small_scene(pkg):
    proc, _ = PKG[pkg]
    return proc.build_test_scene(viewport=(96, 96), n_spheres=1)


def colored_box(pkg, scene, rgb, extents=(1.0, 1.0, 1.0)):
    """A new box segment with a new material of colour ``rgb``."""
    proc, mod = PKG[pkg]
    mat = scene.add_material(mod.Material(
        base_color_factor=np.array([*rgb, 1.0], np.float32)))
    box = proc.make_box(extents)
    box.material = mat
    return scene.add_segment(box)


def assert_arrays_equal(ours, ref, rgba8_pool=True, skip=()):
    """Every field of the port's SceneArrays equals the JAX one's, but for
    ``skip``. Without ``rgba8_pool`` the RGBA8 pool (``textures.*``) is left
    out: a texture added after the build reaches the JAX scene's pool on the
    CPU, whose arrays may alias the texture builder's numpy buffers
    (reference fault R9), while the port's pool stays as built, as the
    reference's streaming intends (``add_texture`` touches no device
    state)."""
    o, r = bridge.numpy_fields(ours), bridge.numpy_fields(ref)
    assert set(o) <= set(r)
    for k in sorted(o):
        if k in skip or (not rgba8_pool and k.startswith("textures.")):
            continue
        a, b = o[k], r[k]
        if b.dtype == np.uint32:
            a = a.view(np.uint32)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def pointers(arrays) -> dict:
    return {k: t.data_ptr() for k, t in _tensors(arrays)}


def _tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            yield from _tensors(v, f"{prefix}{k}.")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}{i}.")
    elif tree is not None and hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, k), f"{prefix}{k}.")


def assert_frame_close(ours, ref):
    diff = np.abs(ours - ref)
    assert (diff > 2e-4).mean() < 0.002, (diff > 2e-4).mean()
    assert abs(ours.mean() - ref.mean()) < 1e-5


@pytest.fixture(scope="module")
def streamed_boxes():
    """Both packages' renderers, a red box streamed twice between frames:
    (frames by package, arrays after each stream by package, the port's
    tensor pointers before and after)."""
    out = {}
    for pkg in ("jax", "torch"):
        scene, cam = small_scene(pkg)
        sid = colored_box(pkg, scene, (0.9, 0.1, 0.1), (1.2, 1.2, 1.2))
        r = renderer(pkg, scene, cam)
        imgs, arrays = [frame(r)], []
        before = pointers(r.scene_arrays) if pkg == "torch" else None
        for w in (translated(1.5, 0.6, 1.5), translated(1.5, 0.6, -1.0)):
            r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, w)
            arrays.append(bridge.numpy_fields(r.scene_arrays))
            imgs.append(frame(r))
        out[pkg] = dict(frames=imgs, arrays=arrays, before=before,
                        after=pointers(r.scene_arrays) if pkg == "torch" else None)
    return out


def test_stream_instance_appears_without_rebuild(streamed_boxes):
    """Each streamed box renders (the frame changes), every field equals
    JAX's after each stream, the frames match JAX's, and no pool tensor
    was replaced."""
    t, j = streamed_boxes["torch"], streamed_boxes["jax"]
    for ours, ref in zip(t["arrays"], j["arrays"]):
        assert_arrays_equal(ours, ref)
    imgs = t["frames"]
    assert np.abs(imgs[1] - imgs[0]).max() > 0.05 and np.abs(imgs[2] - imgs[1]).max() > 0.05
    for ours, ref in zip(imgs, j["frames"]):
        assert np.isfinite(ours).all()
        assert_frame_close(ours, ref)
    assert t["before"] == t["after"]


def test_stream_instance_capacity_error():
    """Both packages fill the vertex pool (32,768 rows: 55 more spheres of
    561 vertices) and then raise "pools full" after the same count."""
    counts = {}
    for pkg in ("jax", "torch"):
        scene, _ = small_scene(pkg)
        arrays = scene.build() if pkg == "jax" else scene.build("cpu")
        n = 0
        with pytest.raises(RuntimeError, match="pools full"):
            for _ in range(1000):
                arrays = scene.stream_instance(arrays, 1, np.eye(4, dtype=np.float32))
                n += 1
        counts[pkg] = n
    assert counts["torch"] == counts["jax"] == 55


def test_stream_matches_full_rebuild():
    """The port's streamed frame equals its rebuilt frame within 1e-5 (its
    frames against JAX's: test_stream_instance_appears_without_rebuild):
    frame 1 of the scene built with a green box against frame 1 of the
    scene that streams the box after frame 0."""
    world = translated(1.8, 0.5, 0.5)
    scene_a, cam_a = small_scene("torch")
    scene_a.add_instance(colored_box("torch", scene_a, (0.2, 0.8, 0.3)), world)
    ra = renderer("torch", scene_a, cam_a)
    frame(ra)
    ref = frame(ra)
    scene_b, cam_b = small_scene("torch")
    sid = colored_box("torch", scene_b, (0.2, 0.8, 0.3))
    rb = renderer("torch", scene_b, cam_b)
    frame(rb)
    rb.scene_arrays = scene_b.stream_instance(rb.scene_arrays, sid, world)
    got = frame(rb)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_budgeted_streaming_state_machine():
    """A large sphere streams over several ticks under a 64 KiB budget in
    1,024-row chunks: each tick's bytes and the ticket's state equal JAX's,
    and so does every field after each tick; the port's frames match a
    lockstep renderer without the sphere until the ticket is LOADED, then
    show it, and equal the immediate path's frame."""
    budget = 64 << 10
    w = translated(1.6, 1.1, 1.4)
    runs = {}
    for pkg, mod in (("jax", jstream), ("torch", tstream)):
        proc, smod = PKG[pkg]
        scene, cam = small_scene(pkg)
        red = scene.add_material(smod.Material(
            base_color_factor=np.array([0.9, 0.1, 0.1, 1.0], np.float32)))
        big = proc.make_uv_sphere(1.1, rings=48, sectors=96)
        big.material = red
        sid = scene.add_segment(big)
        arrays = scene.build() if pkg == "jax" else scene.build("cpu")
        built = bridge.numpy_fields(arrays)["tri_material"]
        mgr = mod.StreamingManager(scene, budget_bytes=budget, chunk_rows=1024)
        ticket = mgr.enqueue_instance(sid, w)
        assert ticket.bytes_total > 4 * budget
        ticks = []
        while mgr.pending:
            arrays = mgr.tick(arrays)
            ticks.append((mgr.bytes_uploaded_last_tick, ticket.state, ticket.bytes_done,
                          bridge.numpy_fields(arrays), {u.field: u.done for u in ticket.uploads}))
            assert len(ticks) < 64
        runs[pkg] = (ticks, ticket, built)
    (t_ticks, t_ticket, t_built), (j_ticks, j_ticket, _) = runs["torch"], runs["jax"]
    assert len(t_ticks) == len(j_ticks) >= 4
    for (tb, ts, td, tf, tdone), (jb, js, jd, jf, jdone) in zip(t_ticks, j_ticks):
        assert (tb, ts, td, tdone) == (jb, js, jd, jdone)
        assert tb <= budget + 1024 * 64
        # Until the ticket is LOADED, JAX's tri_material may alias the host
        # mirror on the CPU and show staged rows early (R9); the port's has
        # only the rows written so far. Once loaded, every field is held.
        assert_arrays_equal(tf, jf, skip=() if ts == tstream.LOADED else ("tri_material",))
    # The port's tri_material holds the rows written so far, the build's
    # past them.
    up = next(u for u in t_ticket.uploads if u.field == "tri_material")
    span = slice(up.offset, up.offset + up.rows.shape[0])
    for *_, fields, done in t_ticks:
        n = done["tri_material"]
        np.testing.assert_array_equal(fields["tri_material"][span][:n], up.rows[:n])
        np.testing.assert_array_equal(fields["tri_material"][span][n:], t_built[span][n:])
    assert t_ticket.state == j_ticket.state == tstream.LOADED

    # The port's frames through the same ticks, against a lockstep
    # renderer of the scene without the sphere.
    scene, cam = small_scene("torch")
    red = scene.add_material(tscene.Material(
        base_color_factor=np.array([0.9, 0.1, 0.1, 1.0], np.float32)))
    big = tproc.make_uv_sphere(1.1, rings=48, sectors=96)
    big.material = red
    sid = scene.add_segment(big)
    r = renderer("torch", scene, cam)
    r_base = renderer("torch", *small_scene("torch"))
    frame(r)
    frame(r_base)
    ptrs = pointers(r.scene_arrays)
    mgr = tstream.StreamingManager(scene, budget_bytes=budget, chunk_rows=1024)
    mgr.enqueue_instance(sid, w)
    diffs = []
    while mgr.pending:
        r.scene_arrays = mgr.tick(r.scene_arrays)
        diffs.append(np.abs(frame(r) - frame(r_base)).max())
    assert max(diffs[:-1]) < 1e-4, diffs
    final = frame(r)
    assert np.abs(final - frame(r_base)).max() > 0.05
    assert pointers(r.scene_arrays) == ptrs

    scene2, cam2 = small_scene("torch")
    red2 = scene2.add_material(tscene.Material(
        base_color_factor=np.array([0.9, 0.1, 0.1, 1.0], np.float32)))
    big2 = tproc.make_uv_sphere(1.1, rings=48, sectors=96)
    big2.material = red2
    sid2 = scene2.add_segment(big2)
    r2 = renderer("torch", scene2, cam2)
    frame(r2)
    r2.scene_arrays = scene2.stream_instance(r2.scene_arrays, sid2, w)
    for _ in range(len(diffs) + 1):
        ref = frame(r2)
    np.testing.assert_allclose(final, ref, atol=1e-5)


def test_async_prepare_then_stream():
    """``enqueue_async`` prepares on a background worker (host work only),
    then the ticket flows through the ticks; the streamed arrays equal
    JAX's, and the frame shows the box."""
    results = {}
    for pkg, mod in (("jax", jstream), ("torch", tstream)):
        scene, cam = small_scene(pkg)
        sid = colored_box(pkg, scene, (0.1, 0.2, 0.9))
        arrays = scene.build() if pkg == "jax" else scene.build("cpu")
        mgr = mod.StreamingManager(scene, budget_bytes=8 << 20)
        ticket = mgr.enqueue_async(lambda s=sid: (s, translated(-1.8, 0.5, 1.2)))
        for _ in range(200):
            arrays = mgr.tick(arrays)
            if not mgr.pending:
                break
            ticket.prepare.result(timeout=30)
        assert ticket.state == mod.LOADED and ticket.instance_id == 3
        results[pkg] = arrays
    assert_arrays_equal(results["torch"], results["jax"])
    scene, cam = small_scene("torch")
    sid = colored_box("torch", scene, (0.1, 0.2, 0.9))
    r = renderer("torch", scene, cam)
    img0 = frame(r)
    mgr = tstream.StreamingManager(scene)
    mgr.enqueue_async(lambda: (sid, translated(-1.8, 0.5, 1.2))).prepare.result(timeout=30)
    r.scene_arrays = mgr.tick(r.scene_arrays)
    assert not mgr.pending and np.abs(frame(r) - img0).max() > 0.05


@pytest.fixture(scope="module")
def rt_streamed():
    """A second sphere streamed into both packages' rt renderers (RT
    shadows and reflections) through a parked TLAS slot, then 4 frames."""
    out = {}
    for pkg in ("jax", "torch"):
        scene, cam = small_scene(pkg)
        r = renderer(pkg, scene, cam, rt_shadows=True, rt_reflections=True)
        img0 = frame(r)
        ptrs = pointers(r.scene_arrays) if pkg == "torch" else None
        r.scene_arrays = scene.stream_instance(r.scene_arrays, 1, translated(1.2, 1.6, 1.2))
        arrays = bridge.numpy_fields(r.scene_arrays)
        imgs = [frame(r) for _ in range(5)]
        out[pkg] = dict(r=r, img0=img0, imgs=imgs, arrays=arrays, ptrs=ptrs)
    return out


def test_streamed_instance_visible_to_rt_without_rebuild(rt_streamed):
    """The streamed sphere's BVH rows and the refit BVH equal JAX's; it
    changes the rt frame, which matches JAX's streamed frame, and matches
    the port's rebuilt scene up to the reference's bound (the BVH's
    topology differs: a streamed leaf against a rebuilt tree)."""
    t, j = rt_streamed["torch"], rt_streamed["jax"]
    assert_arrays_equal(t["arrays"], j["arrays"])
    assert pointers(t["r"].scene_arrays) == t["ptrs"]
    assert np.abs(t["imgs"][0] - t["img0"]).max() > 0.05
    for ours, ref in zip(t["imgs"], j["imgs"]):
        assert np.isfinite(ours).all()
        assert_frame_close(ours, ref)
    scene2, cam2 = small_scene("torch")
    scene2.add_instance(1, translated(1.2, 1.6, 1.2))
    r2 = renderer("torch", scene2, cam2, rt_shadows=True, rt_reflections=True)
    for _ in range(t["r"].frame_index):
        img2 = frame(r2)
    diff = np.abs(t["imgs"][-1] - img2)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def red_texture(size):
    tex = np.zeros((size, size, 4), np.uint8)
    tex[..., 0] = 255
    tex[..., 3] = 255
    return tex


def test_streamed_material_texture_chain():
    """A material with a texture registered after the build streams its
    texel chain and record (equal to JAX's rows); a box streamed with it
    renders red from the streamed texels, as JAX's frame does."""
    out = {}
    for pkg in ("jax", "torch"):
        _, mod = PKG[pkg]
        scene, cam = small_scene(pkg)
        r = renderer(pkg, scene, cam)
        img0 = frame(r)
        tid = scene.add_texture(red_texture(8), srgb=True)
        r.scene_arrays, mid = scene.stream_material(r.scene_arrays,
                                                    mod.Material(base_color_tex=tid))
        sid = PKG[pkg][0].make_box((1.0, 1.0, 1.0))
        sid.material = mid
        sid = scene.add_segment(sid)
        r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, translated(1.5, 0.8, 1.5))
        out[pkg] = (img0, frame(r), bridge.numpy_fields(r.scene_arrays), mid)
    (img0, img1, t_fields, t_mid), (_, j_img1, j_fields, j_mid) = out["torch"], out["jax"]
    assert t_mid == j_mid
    assert_arrays_equal(t_fields, j_fields, rgba8_pool=False)
    assert_frame_close(img1, j_img1)
    changed = np.abs(img1 - img0).max(axis=-1) > 0.05
    assert changed.any()
    red = img1[..., 0] - np.maximum(img1[..., 1], img1[..., 2])
    assert (red[changed] > 0.02).mean() > 0.5


def test_streamed_material_via_streaming_manager_budget():
    """The texel chain through the manager under a 4 KiB budget: texel rows
    first, the record last, the same ticks, bytes and rows as JAX's; then
    a box with the material renders red."""
    runs = {}
    for pkg, mod in (("jax", jstream), ("torch", tstream)):
        _, smod = PKG[pkg]
        scene, cam = small_scene(pkg)
        r = renderer(pkg, scene, cam) if pkg == "torch" else None
        arrays = r.scene_arrays if r else scene.build()
        tid = scene.add_texture(red_texture(32), srgb=True)
        mgr = mod.StreamingManager(scene, budget_bytes=4 << 10)
        t = mgr.enqueue_material(smod.Material(base_color_tex=tid))
        assert t.material_id >= 0
        assert t.uploads[0].field == "mat_tex.rows" and t.uploads[-1].field == "mat_records"
        ticks = []
        while mgr.pending and len(ticks) < 64:
            arrays = mgr.tick(arrays)
            ticks.append((mgr.bytes_uploaded_last_tick, t.state))
        assert t.state == "loaded" and len(ticks) > 1
        runs[pkg] = (ticks, bridge.numpy_fields(arrays), scene, r, t)
    assert runs["torch"][0] == runs["jax"][0]
    assert_arrays_equal(runs["torch"][1], runs["jax"][1], rgba8_pool=False)
    _, _, scene, r, t = runs["torch"]
    box = tproc.make_box((1.0, 1.0, 1.0))
    box.material = t.material_id
    sid = scene.add_segment(box)
    r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, translated(1.5, 0.8, 1.5))
    img = frame(r)
    assert np.isfinite(img).all()
    assert ((img[..., 0] - np.maximum(img[..., 1], img[..., 2])) > 0.02).any()


def test_streamed_material_pool_full():
    """512^2 textures until a pool is full: the port raises naming the pool
    after as many materials as JAX (the texture builder's texel pool or
    the packed rows, whichever fills first), and keeps no material of the
    failed stage."""
    counts = {}
    for pkg in ("jax", "torch"):
        _, mod = PKG[pkg]
        scene, _ = small_scene(pkg)
        arrays = scene.build() if pkg == "jax" else scene.build("cpu")
        big = np.zeros((512, 512, 4), np.uint8)
        big[..., 3] = 255
        n_mats = len(scene.materials)
        with pytest.raises((RuntimeError, AssertionError, ValueError), match="pool"):
            for _ in range(64):
                tid = scene.add_texture(big, srgb=False)
                arrays, _ = scene.stream_material(arrays, mod.Material(base_color_tex=tid))
        assert len(scene.materials) < n_mats + 64
        counts[pkg] = len(scene.materials) - n_mats
    assert counts["torch"] == counts["jax"]


def test_streamed_instance_rt_via_streaming_manager():
    """The sphere through the manager under a 16 KiB budget into an
    RT-shadowed renderer: the same ticks and rows as JAX's (the refit on
    the last one), and then the frame changes."""
    runs = {}
    for pkg, mod in (("jax", jstream), ("torch", tstream)):
        scene, cam = small_scene(pkg)
        arrays = scene.build(with_bvh=True) if pkg == "jax" else scene.build("cpu", True)
        mgr = mod.StreamingManager(scene, budget_bytes=16 << 10)
        t = mgr.enqueue_instance(1, translated(1.2, 1.6, 1.2))
        ticks = []
        while mgr.pending and len(ticks) < 64:
            arrays = mgr.tick(arrays)
            ticks.append((mgr.bytes_uploaded_last_tick, t.state))
        assert t.state == "loaded"
        runs[pkg] = (ticks, bridge.numpy_fields(arrays))
    assert runs["torch"][0] == runs["jax"][0]
    assert_arrays_equal(runs["torch"][1], runs["jax"][1])
    scene, cam = small_scene("torch")
    r = renderer("torch", scene, cam, rt_shadows=True)
    img0 = frame(r)
    mgr = tstream.StreamingManager(scene, budget_bytes=16 << 10)
    t = mgr.enqueue_instance(1, translated(1.2, 1.6, 1.2))
    while mgr.pending:
        r.scene_arrays = mgr.tick(r.scene_arrays)
    img1 = frame(r)
    assert t.state == "loaded" and np.isfinite(img1).all()
    assert np.abs(img1 - img0).max() > 0.05


def skinned_scene(pkg, extra: bool, rigid_copy: bool = False):
    """The test scene with a skinned box (one joint whose rest pose lifts
    it 0.8) at w0, and at w1 too when ``extra``; ``rigid_copy`` adds an
    unskinned box segment. Returns (scene, camera, streamed segment, w1)."""
    proc, mod = PKG[pkg]
    anim = janim if pkg == "jax" else tanim
    scene, cam = small_scene(pkg)
    skel = scene.add_skeleton(anim.Skeleton(
        parents=np.array([-1], np.int32), inverse_bind=np.eye(4, dtype=np.float32)[None],
        rest_translation=np.array([[0.4, 0.8, 0.0]], np.float32),
        rest_rotation=np.array([[0, 0, 0, 1]], np.float32),
        rest_scale=np.ones((1, 3), np.float32)))
    box = proc.make_box((0.8, 0.8, 0.8))
    box.material = scene.add_material(mod.Material(
        base_color_factor=np.array([0.9, 0.2, 0.2, 1.0], np.float32)))
    v = box.positions.shape[0]
    box.skeleton = skel
    box.skin_joints = np.zeros((v, 4), np.int32)
    box.skin_weights = np.tile(np.array([1, 0, 0, 0], np.float32), (v, 1))
    sid = scene.add_segment(box)
    scene.add_instance(sid, translated(-1.5, 0.6, 1.2))
    w1 = translated(1.6, 0.6, -0.4)
    if extra:
        scene.add_instance(sid, w1)
    if rigid_copy:
        rigid = proc.make_box((0.8, 0.8, 0.8))
        rigid.material = box.material
        sid = scene.add_segment(rigid)
    return scene, cam, sid, w1


def test_streamed_skinned_instance_matches_rebuild():
    """A skinned instance streamed into a skinning scene: its rows (palette
    range, skin pools) equal JAX's, its frame equals the rebuilt scene's
    within 1e-5, and differs from a rigid box streamed at the same place
    (so it skins)."""
    scene_a, cam_a, _, _ = skinned_scene("torch", extra=True)
    ra = renderer("torch", scene_a, cam_a)
    frame(ra)
    ref = frame(ra)
    streamed = {}
    for pkg in ("jax", "torch"):
        scene_b, cam_b, sid, w1 = skinned_scene(pkg, extra=False)
        rb = renderer(pkg, scene_b, cam_b) if pkg == "torch" else None
        arrays = rb.scene_arrays if rb else scene_b.build()
        if rb:
            frame(rb)
        arrays = scene_b.stream_instance(arrays, sid, w1)
        streamed[pkg] = bridge.numpy_fields(arrays)
        if rb:
            rb.scene_arrays = arrays
            got = frame(rb)
    assert_arrays_equal(streamed["torch"], streamed["jax"])
    np.testing.assert_allclose(got, ref, atol=1e-5)
    scene_c, cam_c, sid_r, w1 = skinned_scene("torch", extra=False, rigid_copy=True)
    rc = renderer("torch", scene_c, cam_c)
    frame(rc)
    rc.scene_arrays = scene_c.stream_instance(rc.scene_arrays, sid_r, w1)
    assert np.abs(frame(rc) - ref).max() > 0.05


def test_streamed_skinned_requires_skin_path():
    """A skinned segment cannot stream into a scene without a skinned
    instance: JAX asserts, the port raises ValueError, both naming the
    skinning path, and neither keeps the instance."""
    for pkg, err in (("jax", AssertionError), ("torch", ValueError)):
        scene, _, sid, _ = skinned_scene(pkg, extra=False)
        scene.instances.pop()  # no skinned instance left at build time
        if pkg == "jax":
            scene.build()
        else:
            scene.build("cpu")
        n = len(scene.instances)
        with pytest.raises(err, match="skinning path"):
            scene.stage_instance(sid, np.eye(4, dtype=np.float32))
        assert len(scene.instances) == n


# -- core/taskgraph (tests/test_aux.py's cases) ------------------------------------


def test_taskgraph_parallel_for():
    out = np.zeros(100)

    def body(i):
        out[i] = i * 2

    ttask.parallel_for(100, body)
    np.testing.assert_array_equal(out, np.arange(100) * 2)


def test_taskgraph_batched_and_futures():
    acc = []
    ttask.parallel_for_batched(10, lambda s, e: acc.append((s, e)), batch=4)
    assert sorted(acc) == [(0, 4), (4, 8), (8, 10)]
    assert ttask.schedule_task(lambda: 42, background=True).result(timeout=30) == 42


def test_pollable_task_progress():
    def work(task):
        task.set_progress(0.5)
        task.set_progress(1.0)
        return "done"

    t = ttask.PollableTask.run(work)
    assert t.result() == "done" and t.done()
    assert t.progress() == 1.0
