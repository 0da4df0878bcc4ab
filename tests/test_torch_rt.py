"""The port's ray-traced frame against the JAX package's: the `rt` pipeline
(the test scene with one sphere and a shadow-casting spot, rt_shadows and
rt_reflections, TAA and Bloom) pass by pass at 96^2 over two frames of a
moving camera, frame 0's persistent state fed to frame 1; the `rt` golden
at 256^2; the RT options that are not ported raise by name, and the soft
shadows' options (ported since) construct and render.

The walk is test_torch_passes.py's: each torch pass gets the JAX input
state of that pass, so differences cannot compound. Both scenes are built
with their BVH (equal arrays, test_torch_bvh.py); the port's is carried
over by the bridge. Tolerances are test_torch_passes.py's, plus:
  * the ray-traced masks (ShadowMask.*) are hard thresholds: a ray's hit can
    flip on an ulp of its origin (XLA:CPU fuses multiply-adds, eager torch
    does not), so they are held by the share of pixels that differ, at most
    0.1 % (none differ in this walk);
  * SceneReflections, RTRefl.history and RTRefl.moments (pre-exposed HDR
    and luma moments, values up to ~2): 1e-4, a few hundred ulps, where
    Visibility agrees (1.5e-5 at most in this walk);
  * RTRefl.depth is the depth buffer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_bvh import rt_scene
from test_torch_passes import DEPTHS, RASTER, RES, _np, _torch_state, compare

torch.set_num_threads(2)

RT_PASSES = ["Scene", "Geometry", "RTShadow", "RTLocalShadow", "VisibilityShading",
             "RTReflections", "LightingCompose", "SkyView", "Bloom", "TAA", "Output"]
RT_KEYS = {"ShadowMask.sun", "ShadowMask.locals", "ShadowMask.points", "SceneReflections",
           "RTRefl.history", "RTRefl.moments", "RTRefl.depth"}
RT_DEPTHS = DEPTHS | {"RTRefl.depth"}
MASKS = {"ShadowMask.sun", "ShadowMask.locals", "ShadowMask.points"}
RT_ATOL = {"SceneReflections": 1e-4, "RTRefl.history": 1e-4, "RTRefl.moments": 1e-4,
           "TAAHistory": 2e-4}
MASK_FLIP_SHARE = 0.001


def compare_rt(key, ours, ref, vis_agree):
    """The RT keys' comparisons; False for a key test_torch_passes compares."""
    if key not in MASKS | RT_DEPTHS | set(RT_ATOL):
        return False
    o, r = _np(ours), _np(ref)
    if key in MASKS:
        assert o.shape == r.shape and (o != r).mean() <= MASK_FLIP_SHARE, key
    elif key in RT_DEPTHS:
        np.testing.assert_allclose(o, r, atol=1e-6, rtol=0, err_msg=key)
    else:
        np.testing.assert_allclose(o[vis_agree], r[vis_agree], atol=RT_ATOL[key], rtol=0,
                                   err_msg=key)
    return True


def walk_rt():
    """Both rt pipelines pass by pass over two frames:
    {(frame, pass): (torch, jax) updates}."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_torch.scene.lights as tlights
    import arkoserenderer_tpu.assets.procedural as jproc
    import arkoserenderer_tpu.scene.lights as jlights

    jscene, jcam = rt_scene(jproc, jlights)
    tscene, _ = rt_scene(tproc, tlights)
    sizes = dict(width=RES, height=RES, shadow_map_size=128, local_shadow_map_size=128)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    kw = dict(rt_shadows=True, rt_reflections=True)
    jpipe = j_make_pipeline(jcfg, **kw)
    tpipe = t_make_pipeline(tcfg, device="cpu", **kw)
    assert [n for n, _ in jpipe._executes] == RT_PASSES == [n for n, _ in tpipe._executes]
    persistent = sorted(jpipe.registry.persistent_names)
    assert persistent == sorted(tpipe.registry.persistent_names)
    assert {"RTRefl.history", "RTRefl.moments", "RTRefl.depth"} <= set(persistent)

    jsa = jscene.build(with_bvh=True)
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes]
    state = jpipe.initial_state()
    out = {}
    for frame in (0, 1):
        if frame == 1:
            jcam.post_render()
            jcam.position = jcam.position + np.array([0.4, 0.0, 0.0], np.float32)
            state = {k: state[k] for k in persistent}
        state["scene.version"] = jnp.asarray(0, jnp.int32)
        jcs = jcam.state(frame)
        tctx = TFrameContext(scene=tsa, camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                             frame_index=frame, delta_time=1 / 60)
        jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(frame, jnp.int32),
                             delta_time=jnp.asarray(1 / 60, jnp.float32),
                             row_offset=jnp.zeros((), jnp.int32))
        for (name, _), jexec, (_, texec) in zip(jpipe._executes, jitted, tpipe._executes):
            tupd = texec(_torch_state(state), tctx)
            jupd = jexec(state, jctx)
            out[frame, name] = (tupd, jupd)
            state = {**state, **jupd}
    return out


@pytest.fixture(scope="module")
def rt_walk():
    return walk_rt()


@pytest.mark.parametrize("frame", [0, 1])
def test_rt_frame_matches_jax(rt_walk, frame):
    """Every published key of every pass of the rt pipeline, for one frame."""
    geo_t, geo_j = rt_walk[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    seen = set()
    for name in RT_PASSES:
        tupd, jupd = rt_walk[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            seen.add(key)
            if not compare_rt(key, tupd[key], jupd[key], vis_agree):
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    assert RT_KEYS <= seen
    assert np.isfinite(_np(rt_walk[frame, "Output"][0]["LDR"])).all()


def test_rt_frame_traces_real_work(rt_walk):
    """The masks shadow real pixels (sun and spot), the mirror sphere and
    the glossy floor reflect, and frame 1's reflection history really
    accumulated (its sample count passed 1 where reprojection held)."""
    for frame in (0, 1):
        sun = _np(rt_walk[frame, "RTShadow"][0]["ShadowMask.sun"])
        spot = _np(rt_walk[frame, "RTLocalShadow"][0]["ShadowMask.locals"])
        assert 0.01 < (sun == 0).mean() < 0.9 and 0.01 < (spot == 0).mean() < 0.9
        refl = _np(rt_walk[frame, "RTReflections"][0]["SceneReflections"])
        assert (refl.max(-1) > 1e-3).mean() > 0.02
    count = _np(rt_walk[1, "RTReflections"][0]["RTRefl.moments"])[..., 2]
    assert count.max() == 2.0 and (count == 2.0).mean() > 0.2


def test_rt_golden():
    """tests/goldens/rt.png (test_golden.py's rt case) rendered by the port
    on the CPU, within the golden test's thresholds."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_torch.scene.lights as tlights
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops.bvh import TwoLevelBVH
    from arkoserenderer_torch.utils.imageio import load_png, to_u8
    from test_torch_forward import GOLDENS, assert_golden_close

    scene, cam = rt_scene(tproc, tlights, res=256)
    cfg = TPipelineConfig(width=256, height=256, shadow_map_size=256,
                          raster=TRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256))
    r = Renderer(scene, cam, cfg, device="cpu", rt_shadows=True, rt_reflections=True,
                 taa=False, bloom=False)
    assert isinstance(r.scene_arrays.bvh, TwoLevelBVH)  # Renderer builds it with_bvh
    img = r.render_frames(2)
    assert_golden_close(to_u8(img.numpy()), load_png(str(GOLDENS / "rt.png"))[..., :3])


def _cfg(**scene):
    from arkoserenderer_torch.scene.scene import SceneStatic

    return TPipelineConfig(width=32, height=16, shadow_map_size=32,
                           raster=TRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64),
                           scene=SceneStatic(**scene))


UNPORTED_RT = {
    "soft sun": (dict(sun_angular_radius_deg=0.5), dict(rt_shadows=True), "angular_radius"),
    "soft spot": (dict(n_spots=1, spot_shadow_casters=(True,), spot_source_radius=(0.1,)),
                  dict(rt_shadows=True), "source_radius"),
    "soft point": (dict(n_points=1, point_shadow_casters=(True,), point_source_radius=(0.05,)),
                   dict(rt_shadows=True), "source_radius"),
    # The refit is ported (test_torch_refit.py); hair, which it would
    # re-read, is not.
    "hair": (dict(has_hair=True), dict(rt_shadows=True, rt_refit=True), "hair"),
    # DDGI is ported (test_torch_showcase.py); its probe overlay is not.
    "ddgi": ({}, dict(rt_reflections=True, ddgi_probe_debug=True), "ddgi_probe_debug"),
}


# Soft RT shadows are ported (test_torch_soft_shadows.py): these cases now
# construct their pipeline and render a frame of a scene with such a light.
SOFT_RT = ("soft sun", "soft spot", "soft point")


def _render_soft(case):
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_torch.scene.lights as tlights
    from arkoserenderer_torch.models.standard import Renderer

    scene, cam = tproc.build_test_scene(viewport=(32, 16), n_spheres=1)
    if case == "soft sun":
        scene.sun.angular_radius_deg = 0.5
    elif case == "soft spot":
        scene.spots.append(tlights.SpotLight(
            position=np.array([0.5, 3.0, 1.0], np.float32),
            direction=np.array([-0.2, -1.0, -0.1], np.float32), cast_shadows=True,
            source_radius=0.1))
    else:
        scene.points.append(tlights.PointLight(position=np.array([1.0, 2.0, 1.0], np.float32),
                                               cast_shadows=True, source_radius=0.05))
    r = Renderer(scene, cam, _cfg(), device="cpu", rt_shadows=True)
    img = r.render_frames(2)
    prefix = "RTShadow" if case == "soft sun" else "RTLocalShadow"
    assert {f"{prefix}.history", f"{prefix}.moments", f"{prefix}.depth"} <= set(r.state)
    assert img.shape == (16, 32, 3) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("case", sorted(UNPORTED_RT))
def test_unported_rt_options_raise_by_name(case):
    scene, flags, name = UNPORTED_RT[case]
    if case in SOFT_RT:
        t_make_pipeline(_cfg(**scene), device="cpu", **flags)
        _render_soft(case)
        return
    with pytest.raises(NotImplementedError, match=name):
        t_make_pipeline(_cfg(**scene), device="cpu", **flags)


def test_rt_scale_and_deformable_scenes_raise_by_name():
    """Half-rate tracing and hair are not ported. A skinned or morphed scene
    under RT refits its BVH every frame (BVHRefit after Geometry, unless
    the caller turns rt_refit off); a rigid one does not."""
    import arkoserenderer_torch.assets.procedural as tproc
    from arkoserenderer_torch.models.standard import Renderer

    with pytest.raises(NotImplementedError, match="rt_scale"):
        dataclasses.replace(_cfg(), rt_scale=2)
    scene, cam = tproc.build_test_scene(viewport=(32, 16))
    rigid = scene.static_info()
    scene.static_info = lambda: dataclasses.replace(rigid, has_hair=True)
    with pytest.raises(NotImplementedError, match="hair"):
        Renderer(scene, cam, _cfg(), device="cpu", rt_reflections=True)
    scene.static_info = lambda: dataclasses.replace(rigid, has_skin=True)
    r = Renderer(scene, cam, _cfg(), device="cpu", rt_shadows=True, rt_reflections=True)
    assert [p.name for p in r.pipeline.passes][1:7] == [
        "Geometry", "BVHRefit", "RTShadow", "VisibilityShading", "RTReflections",
        "LightingCompose"]
    r = Renderer(scene, cam, _cfg(), device="cpu", rt_shadows=True, rt_refit=False)
    assert "BVHRefit" not in [p.name for p in r.pipeline.passes]
    # Rigid, the same scene builds with its BVH and passes in the order.
    scene.static_info = lambda: rigid
    r = Renderer(scene, cam, _cfg(), device="cpu", rt_shadows=True, rt_reflections=True)
    assert [p.name for p in r.pipeline.passes][2:6] == ["RTShadow", "VisibilityShading",
                                                         "RTReflections", "LightingCompose"]
