"""The port's animation host code, skinning and morph targets against the
JAX package's.

* ``sample_channel`` (step, linear, rotation slerp, cubic spline),
  ``evaluate_pose`` over a three-joint chain and a clip, and
  ``topo_sort_joints``: both are host numpy; palettes to atol 1e-6.
* ``skin_vertices`` on random palettes with static rows (all-zero
  weights) and ``apply_morphs`` with two blocks: atol 1e-5 (einsums on two
  backends). Both return new tensors: the inputs stay as they were, and a
  second frame from the same base pools gives the same geometry.
* The bench's test_anim scene (``build_anim_scene``): the skinning pools,
  the palette pool, the morph tuples, ``morph_vertex_base`` and the BVH's
  ``slot_inst`` / ``blas_root`` equal to JAX's, field for field.
* ``update_animations`` at five times with a clip on the joint and one on
  the morph weights: palette and weights to atol 1e-6.

``anim_scene`` builds the test_anim scene with either package's modules;
``tests/test_torch_refit.py`` and ``tests/test_torch_ssss.py`` use it with
``moving=True``, which adds those two clips.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.ops import skinning as t_skin
from arkoserenderer_torch.scene import animation as t_anim
from arkoserenderer_tpu.ops import skinning as j_skin
from arkoserenderer_tpu.scene import animation as j_anim
from test_torch_scene import assert_field_equal

torch.set_num_threads(2)

PACKAGES = {"torch": "arkoserenderer_torch", "jax": "arkoserenderer_tpu"}


def _mods(pkg: str):
    root = PACKAGES[pkg]
    return (importlib.import_module(f"{root}.assets.procedural"),
            importlib.import_module(f"{root}.scene.animation"),
            importlib.import_module(f"{root}.scene.scene"))


def joint_clip(anim):
    """A 1 s clip on joint 0: it rises 0.3 and swings 40 degrees about y."""
    s, c = np.sin(np.radians(20.0)), np.cos(np.radians(20.0))
    return anim.AnimationClip(channels=[
        anim.AnimChannel(0, "translation", np.array([0.0, 0.5, 1.0], np.float32),
                         np.array([[0, 0.6, 0], [0.2, 0.9, 0], [0, 0.6, 0]], np.float32)),
        anim.AnimChannel(0, "rotation", np.array([0.0, 1.0], np.float32),
                         np.array([[0, 0, 0, 1], [0, s, 0, c]], np.float32)),
    ], name="swing")


def weights_clip(anim):
    """A 1 s clip on the morph weights: 0.5 -> 1.0 -> 0.0."""
    return anim.AnimationClip(channels=[
        anim.AnimChannel(-1, "weights", np.array([0.0, 0.5, 1.0], np.float32),
                         np.array([[0.5], [1.0], [0.0]], np.float32)),
    ], name="inflate")


def anim_scene(pkg: str, viewport=(96, 96), moving: bool = False):
    """The reference bench's test_anim scene built with ``pkg``'s modules
    ("torch" or "jax"): the test scene, a box skinned to a one-joint
    skeleton whose rest pose lifts it 0.6, and a sphere with an inflate
    target at weight 0.5. ``moving`` adds ``joint_clip`` to the box and
    ``weights_clip`` to the sphere."""
    proc, anim, scn = _mods(pkg)
    scene, camera = proc.build_test_scene(viewport=viewport)
    skel = scene.add_skeleton(anim.Skeleton(
        parents=np.array([-1], np.int32),
        inverse_bind=np.eye(4, dtype=np.float32)[None],
        rest_translation=np.array([[0.0, 0.6, 0.0]], np.float32),
        rest_rotation=np.array([[0, 0, 0, 1]], np.float32),
        rest_scale=np.ones((1, 3), np.float32),
    ))
    box = proc.make_box((0.7, 0.7, 0.7))
    box.material = scene.add_material(scn.Material(
        base_color_factor=np.array([0.8, 0.6, 0.2, 1.0], np.float32)))
    nv = box.positions.shape[0]
    box.skeleton = skel
    box.skin_joints = np.zeros((nv, 4), np.int32)
    box.skin_weights = np.tile(np.array([1, 0, 0, 0], np.float32), (nv, 1))
    wb = np.eye(4, dtype=np.float32)
    wb[:3, 3] = (2.2, 0.0, 1.2)
    clips = ((scene.add_animation(joint_clip(anim)), scene.add_animation(weights_clip(anim)))
             if moving else (None, None))
    scene.add_instance(scene.add_segment(box), wb, clip=clips[0])
    sph = proc.make_uv_sphere(0.5, rings=12, sectors=24)
    sph.material = box.material
    sph.morph_pos = sph.normals[None] * 0.4
    sph.morph_nrm = np.zeros((1, len(sph.normals), 3), np.float32)
    ws = np.eye(4, dtype=np.float32)
    ws[:3, 3] = (-2.6, 0.5, 1.5)
    scene.add_instance(scene.add_segment(sph), ws, clip=clips[1])
    scene.set_morph_weights(np.array([0.5], np.float32))
    return scene, camera


# -- host animation ------------------------------------------------------------


def _channels(anim, rng):
    times = np.array([0.0, 0.3, 0.7, 1.2], np.float32)
    q = rng.normal(size=(4, 4)).astype(np.float32)
    return [
        anim.AnimChannel(0, "translation", times, rng.normal(size=(4, 3)).astype(np.float32),
                         anim.INTERP_STEP),
        anim.AnimChannel(1, "translation", times, rng.normal(size=(4, 3)).astype(np.float32)),
        anim.AnimChannel(1, "rotation", times, q / np.linalg.norm(q, axis=-1, keepdims=True)),
        anim.AnimChannel(2, "scale", times, rng.uniform(0.5, 1.5, (4, 3)).astype(np.float32)),
        anim.AnimChannel(2, "rotation", times, rng.normal(size=(12, 4)).astype(np.float32),
                         anim.INTERP_CUBICSPLINE),
        anim.AnimChannel(-1, "weights", times, rng.uniform(0, 1, (4, 2)).astype(np.float32)),
    ]


TIMES = (-0.5, 0.0, 0.15, 0.3, 0.55, 0.99, 1.2, 2.0)


def test_sample_channel_matches_jax():
    """Every interpolation mode, at the keys, between them and clamped
    outside them."""
    rng = np.random.default_rng(3)
    t_chs = _channels(t_anim, rng)
    j_chs = [j_anim.AnimChannel(c.target_joint, c.path, c.times, c.values, c.interpolation)
             for c in t_chs]
    for tc, jc in zip(t_chs, j_chs):
        for t in TIMES:
            ours = np.asarray(t_anim.sample_channel(tc, t), np.float32)
            ref = np.asarray(j_anim.sample_channel(jc, t), np.float32)
            np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0,
                                       err_msg=f"{tc.path} interp {tc.interpolation} t={t}")


def _chain(anim, rng):
    """A three-joint chain (root, child, grandchild) with random rest TRS
    and inverse binds."""
    q = rng.normal(size=(3, 4)).astype(np.float32)
    return anim.Skeleton(
        parents=np.array([-1, 0, 1], np.int32),
        inverse_bind=np.linalg.inv(
            np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
            + rng.normal(size=(3, 4, 4)).astype(np.float32) * np.array(
                [[0.1, 0.1, 0.1, 1.0]] * 3 + [[0, 0, 0, 0]], np.float32)).astype(np.float32),
        rest_translation=rng.normal(size=(3, 3)).astype(np.float32),
        rest_rotation=q / np.linalg.norm(q, axis=-1, keepdims=True),
        rest_scale=rng.uniform(0.8, 1.2, (3, 3)).astype(np.float32),
    )


def test_evaluate_pose_and_topo_sort_match_jax():
    rng = np.random.default_rng(5)
    skel_t = _chain(t_anim, rng)
    skel_j = j_anim.Skeleton(**{k: getattr(skel_t, k) for k in
                                ("parents", "inverse_bind", "rest_translation",
                                 "rest_rotation", "rest_scale")})
    chs = _channels(t_anim, rng)
    clip_t = t_anim.AnimationClip(chs)
    clip_j = j_anim.AnimationClip([j_anim.AnimChannel(c.target_joint, c.path, c.times,
                                                      c.values, c.interpolation) for c in chs])
    assert clip_t.duration == clip_j.duration
    for clip_ours, clip_ref in ((None, None), (clip_t, clip_j)):
        for t in TIMES:
            ours, w_ours = t_anim.evaluate_pose(skel_t, clip_ours, t)
            ref, w_ref = j_anim.evaluate_pose(skel_j, clip_ref, t)
            assert ours.dtype == np.float32 and ours.shape == (3, 4, 4)
            np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0, err_msg=f"t={t}")
            assert (w_ours is None) == (w_ref is None)
            if w_ref is not None:
                np.testing.assert_allclose(w_ours, w_ref, atol=1e-6, rtol=0)
    for parents in ([-1, 0, 1], [2, 0, -1, 1], [3, -1, 1, 1, 0]):
        parents = np.array(parents, np.int32)
        ours, ref = t_anim.topo_sort_joints(parents), j_anim.topo_sort_joints(parents)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


# -- skinning and morphs --------------------------------------------------------


def test_skin_vertices_matches_jax():
    """Random palettes; a third of the vertices static (all-zero weights),
    which keep their rows exactly."""
    rng = np.random.default_rng(7)
    v, j = 300, 6
    pos = rng.normal(size=(v, 3)).astype(np.float32)
    nrm = rng.normal(size=(v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tan = np.concatenate([rng.normal(size=(v, 3)), np.sign(rng.normal(size=(v, 1)))],
                         -1).astype(np.float32)
    joints = rng.integers(0, j, (v, 4)).astype(np.int32)
    weights = rng.uniform(0, 1, (v, 4)).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    weights[::3] = 0.0
    palette = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
    palette[:, :3, :] += rng.normal(size=(j, 3, 4)).astype(np.float32) * 0.3
    args = (pos, nrm, tan, joints, weights, palette)
    ours = t_skin.skin_vertices(*(torch.from_numpy(a) for a in args))
    ref = j_skin.skin_vertices(*(jnp.asarray(a) for a in args))
    for name, o, r in zip(("positions", "normals", "tangents"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(ours[0].numpy()[::3], pos[::3])
    np.testing.assert_array_equal(ours[2].numpy()[:, 3], tan[:, 3])
    assert np.abs(ours[0].numpy()[1::3] - pos[1::3]).max() > 0.1


def test_apply_morphs_matches_jax_out_of_place():
    """Two blocks applied in turn, as the Scene pass applies them; the base
    pools are left as they were, so a second frame gives the same result."""
    rng = np.random.default_rng(9)
    v = 200
    pos = rng.normal(size=(v, 3)).astype(np.float32)
    nrm = rng.normal(size=(v, 3)).astype(np.float32)
    blocks = [(20, rng.normal(size=(2, 50, 3)).astype(np.float32),
               rng.normal(size=(2, 50, 3)).astype(np.float32) * 0.1,
               np.array([0.3, 0.8], np.float32)),
              (120, rng.normal(size=(1, 40, 3)).astype(np.float32),
               np.zeros((1, 40, 3), np.float32), np.array([0.5], np.float32))]
    tp, tn = torch.from_numpy(pos.copy()), torch.from_numpy(nrm.copy())
    jp, jn = jnp.asarray(pos), jnp.asarray(nrm)

    def frame():
        p, n = tp, tn
        for base, dp, dn, w in blocks:
            p, n = t_skin.apply_morphs(p, n, *(torch.from_numpy(a) for a in (dp, dn, w)), base)
        return p, n

    first = frame()
    for base, dp, dn, w in blocks:
        jp, jn = j_skin.apply_morphs(jp, jn, jnp.asarray(dp), jnp.asarray(dn), jnp.asarray(w),
                                     base)
    np.testing.assert_allclose(first[0].numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    np.testing.assert_allclose(first[1].numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tp.numpy(), pos)
    np.testing.assert_array_equal(tn.numpy(), nrm)
    second = frame()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    untouched = np.r_[0:20, 70:120, 160:v]
    np.testing.assert_array_equal(first[0].numpy()[untouched], pos[untouched])


# -- the test_anim scene ---------------------------------------------------------


ANIM_FIELDS = ("skin_joints", "skin_weights", "palette", "morph_pos.0", "morph_nrm.0",
               "morph_weights.0", "bvh.slot_inst", "bvh.blas_root", "positions", "indices",
               "vertex_instance", "world")


@pytest.fixture(scope="module")
def built_anim_scenes():
    from arkoserenderer_torch.assets.procedural import build_anim_scene

    js, _ = anim_scene("jax")
    ts, _ = build_anim_scene(viewport=(96, 96))
    return js, ts, js.build(with_bvh=True), ts.build("cpu", with_bvh=True)


def test_anim_scene_matches_jax(built_anim_scenes):
    """The bench's scene: every pool the animated path reads equal to JAX's,
    the BVH's deformable slots owned by the box's and the sphere's TLAS
    slots, and the same static facts (morph_vertex_base included)."""
    js, ts, jsa, tsa = built_anim_scenes
    ref = bridge.numpy_fields(jsa)
    ours = bridge.numpy_fields(tsa)
    for name in ANIM_FIELDS:
        assert_field_equal(name, ours[name], ref[name])
    assert set(ours) <= set(ref)
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    assert {k for k in ours if k.startswith("morph_")} == {
        "morph_pos.0", "morph_nrm.0", "morph_weights.0"}
    owners = np.unique(ours["bvh.slot_inst"])
    assert list(owners) == [-1, 5, 6]  # the box's and the sphere's TLAS slots
    jst, tst = js.static_info(), ts.static_info()
    for f in type(tst).__dataclass_fields__:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.has_skin and tst.has_morphs and tst.morph_vertex_base == (1027,)
    np.testing.assert_array_equal(ours["palette"][0], np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0.6], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32))


def test_update_animations_matches_jax():
    """Both clips at five times, looping past the 1 s duration: the palette
    pool and the weights of the morph block."""
    js, _ = anim_scene("jax", moving=True)
    ts, _ = anim_scene("torch", moving=True)
    js.build()
    ts.build("cpu")
    for t in (0.0, 0.25, 0.5, 0.8, 1.3):
        ours, ref = ts.update_animations(t), js.update_animations(t)
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0, err_msg=f"t={t}")
        np.testing.assert_allclose(ts.morph_weights()[0], js._morph_weights_list[0],
                                   atol=1e-6, rtol=0)
    assert abs(ours[0, 1, 3] - 0.6) > 0.05  # the joint moved
