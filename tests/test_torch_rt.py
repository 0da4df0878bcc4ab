"""The port's ray-traced frame against the JAX package's: the `rt` pipeline
(the test scene with one sphere and a shadow-casting spot, rt_shadows and
rt_reflections, TAA and Bloom) pass by pass at 96^2 over two frames of a
moving camera, frame 0's persistent state fed to frame 1, with RTShadow
and RTReflections of the half-rate pipeline (``rt_scale=2``) run on the
same input states; a soft sun's half-rate RTShadow at 32x16 over two
frames; the port's half-rate frame against its full-rate one (the
reference's bound); the `rt` golden at 256^2; the RT options that are not
ported raise by name, and the soft shadows' options (ported since)
construct and render.

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
  * RTRefl.depth is the depth buffer;
  * the soft sun's denoised mask and its moments mix a flipped ray into
    their neighbourhood: as in test_torch_soft_shadows.py, at most 2 % of
    their values may differ by more than 1e-4.
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


HALF_RATE = ("RTShadow", "RTReflections")


def walk_rt():
    """Both rt pipelines pass by pass over two frames:
    {(frame, pass): (torch, jax) updates}, and (frame, "<pass>@2") for the
    half-rate pipelines' RTShadow and RTReflections on the same states."""
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
    jhalf = dict(j_make_pipeline(dataclasses.replace(jcfg, rt_scale=2), **kw)._executes)
    thalf = dict(t_make_pipeline(dataclasses.replace(tcfg, rt_scale=2), device="cpu",
                                 **kw)._executes)
    assert list(jhalf) == RT_PASSES == list(thalf)
    jhalf = {name: jax.jit(jhalf[name]) for name in HALF_RATE}
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
            if name in HALF_RATE:
                out[frame, f"{name}@2"] = (thalf[name](_torch_state(state), tctx),
                                           jhalf[name](state, jctx))
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


@pytest.mark.parametrize("frame", [0, 1])
def test_rt_half_rate_matches_jax(rt_walk, frame):
    """RTShadow and RTReflections at rt_scale=2, on the full-rate walk's
    input states: every key they publish, under the walk's tolerances."""
    geo_t, geo_j = rt_walk[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    for name in HALF_RATE:
        tupd, jupd = rt_walk[frame, f"{name}@2"]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            assert compare_rt(key, tupd[key], jupd[key], vis_agree), key
    # A quarter of the rays: the half-rate mask is not the full-rate one.
    half = _np(rt_walk[frame, "RTShadow@2"][0]["ShadowMask.sun"])
    full = _np(rt_walk[frame, "RTShadow"][0]["ShadowMask.sun"])
    assert 0.01 < (half == 0).mean() < 0.9 and (half != full).any()


@pytest.fixture(scope="module")
def soft_half_walk():
    """A soft sun's (10 degrees) half-rate RTShadow at 32x16 over two frames
    of a moving camera, both packages' passes fed the same depth and
    visibility (the port's Scene and Geometry passes'; test_torch_passes.py
    holds those to JAX's) and JAX's RTShadow state of the frame before:
    {frame: (torch, jax) updates}."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_tpu.assets.procedural as jproc

    scenes = []
    for proc in (jproc, tproc):
        scene, cam = proc.build_test_scene(viewport=(32, 16), n_spheres=1)
        scene.sun.angular_radius_deg = 10.0
        scenes.append((scene, cam))
    (jscene, jcam), (tscene, _) = scenes
    sizes = dict(width=32, height=16, shadow_map_size=32, rt_scale=2)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    kw = dict(rt_shadows=True, taa=False, bloom=False)
    jpipe = j_make_pipeline(jcfg, **kw)
    tpipe = t_make_pipeline(tcfg, device="cpu", **kw)
    names = ["Scene", "Geometry", "RTShadow"]
    assert [n for n, _ in jpipe._executes][:3] == names == [n for n, _ in tpipe._executes][:3]
    jexec = jax.jit(jpipe._executes[2][1])
    jsa = jscene.build(with_bvh=True)
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    state = {k: v for k, v in jpipe.initial_state().items() if k.startswith("RTShadow.")}
    out = {}
    for frame in (0, 1):
        if frame:
            jcam.post_render()
            jcam.position = jcam.position + np.array([0.25, 0.05, 0.0], np.float32)
        jcs = jcam.state(frame)
        tctx = TFrameContext(scene=tsa, camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                             frame_index=frame, delta_time=1 / 60)
        jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(frame, jnp.int32),
                             delta_time=jnp.asarray(1 / 60, jnp.float32),
                             row_offset=jnp.zeros((), jnp.int32))
        tstate = {"scene.version": 0, **_torch_state(state)}
        for _, texec in tpipe._executes[:2]:
            tstate.update(texec(tstate, tctx))
        inputs = {k: jnp.asarray(tstate[k].numpy()) for k in ("SceneDepth", "Visibility")}
        out[frame] = (tpipe._executes[2][1](tstate, tctx), jexec({**state, **inputs}, jctx))
        state = {k: v for k, v in out[frame][1].items() if k.startswith("RTShadow.")}
    return out


@pytest.mark.parametrize("frame", [0, 1])
def test_soft_sun_half_rate_matches_jax(soft_half_walk, frame):
    tupd, jupd = soft_half_walk[frame]
    assert set(tupd) == set(jupd) == {"ShadowMask.sun", "RTShadow.history", "RTShadow.moments",
                                      "RTShadow.depth"}
    for key in sorted(jupd):
        o, r = _np(tupd[key]), _np(jupd[key])
        assert o.shape == r.shape, key
        if key.endswith(".depth"):
            np.testing.assert_allclose(o, r, atol=1e-6, rtol=0, err_msg=key)
        else:
            assert (np.abs(o - r) > 1e-4).mean() <= 0.02, (key, np.abs(o - r).max())
    assert _np(tupd["RTShadow.moments"])[..., 2].max() == frame + 1


def test_half_rate_rt_matches_full_rate_roughly():
    """Port twin of test_rt_passes.py::test_half_res_rt_matches_full_res_roughly
    at 96^2: the rt_scale=2 frame (shadows and reflections at a quarter of
    the rays, nearest-depth reconstructed) against the full-rate one, mean
    abs < 0.02 and under 6 % of pixels off by more than 0.1."""
    import arkoserenderer_torch.assets.procedural as tproc
    from arkoserenderer_torch.models.standard import Renderer

    cfg = TPipelineConfig(width=96, height=96, shadow_map_size=128,
                          raster=TRasterConfig(**RASTER))
    frames = []
    for rt_scale in (1, 2):
        scene, cam = tproc.build_test_scene(viewport=(96, 96), n_spheres=1)
        r = Renderer(scene, cam, dataclasses.replace(cfg, rt_scale=rt_scale), device="cpu",
                     rt_shadows=True, rt_reflections=True, taa=False, bloom=False)
        frames.append(r.render_frame().numpy())
    a, b = frames
    assert np.isfinite(b).all()
    assert np.abs(a - b).mean() < 0.02
    assert (np.abs(a - b).max(axis=-1) > 0.1).mean() < 0.06


@pytest.mark.parametrize("name", ["rt", "rt_soft"])
def test_bench_rt_kinds_at_half_rate_small(name, monkeypatch):
    """The bench's rt and rt_soft kinds at 256^2 and rt_scale=2 on the CPU:
    one finite frame, the traces by label as at full rate, the sun mask
    and the reflections at a quarter of the rays (128^2), the spot's mask
    at every pixel."""
    import collections

    from arkoserenderer_torch.ops import bvh as bvh_ops
    from arkoserenderer_torch.ops import rt
    from arkoserenderer_torch.rendering.passes import rt as rt_passes
    from arkoserenderer_torch.tools import bench

    r = bench.build_renderer(name, small=True, device="cpu",
                             cfg=bench.pipeline_config(True, rt_scale=2))
    assert r.cfg.rt_scale == 2
    rays = collections.defaultdict(list)

    def by_label(bvh, origins, *args, label=None, **kw):
        rays[label].append(origins.shape[0])
        return bvh_ops.trace_rays(bvh, origins, *args, label=label, **kw)

    for mod in (rt, rt_passes):
        monkeypatch.setattr(mod, "trace_rays", by_label)
    img = r.render_frame()
    assert torch.isfinite(img).all() and r.state["SceneCoverage"].any()
    assert {k: len(v) for k, v in rays.items()} == bench.expected_trace_launches_by_label(r, 1)
    assert rays["sun mask"] == rays["reflection"] == [128 * 128]
    assert rays["spot mask 0"] == [256 * 256]


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
    # The refit is ported (test_torch_refit.py), and hair since: it builds.
    "hair": (dict(has_hair=True), dict(rt_shadows=True, rt_refit=True), "hair"),
    # DDGI is ported (test_torch_showcase.py), and its probe overlay since;
    # without DDGI the flag adds no pass, as in the reference.
    "ddgi": ({}, dict(rt_reflections=True, ddgi_probe_debug=True), "ddgi_probe_debug"),
}
# Ported since they were listed: the pipeline the reference builds.
PORTED_RT = {"hair": ["Scene", "Geometry", "BVHRefit", "RTShadow", "VisibilityShading"],
             "ddgi": ["Scene", "Geometry", "SunShadow", "VisibilityShading", "RTReflections"]}


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
    if case in PORTED_RT:
        names = [p.name for p in t_make_pipeline(_cfg(**scene), device="cpu", **flags).passes]
        assert names[:5] == PORTED_RT[case] and "DDGIProbeDebug" not in names
        return
    with pytest.raises(NotImplementedError, match=name):
        t_make_pipeline(_cfg(**scene), device="cpu", **flags)


def test_rt_scale_and_deformable_scenes_raise_by_name():
    """Half-rate tracing is ported: rt_scale=2 builds the reference's RT
    passes and renders (test_rt_half_rate_matches_jax holds them to JAX's),
    and a rate the reference cannot run raises ValueError naming the field.
    A hair scene (ported since) under RT builds as the reference's does:
    the BVH traced as built, no refit of the ribbons. A skinned or morphed
    scene under RT refits its BVH every frame (BVHRefit after Geometry,
    unless the caller turns rt_refit off); a rigid one does not."""
    import arkoserenderer_torch.assets.procedural as tproc
    from arkoserenderer_torch.models.standard import Renderer

    scene, cam = tproc.build_test_scene(viewport=(32, 16), n_spheres=1)
    r = Renderer(scene, cam, dataclasses.replace(_cfg(), rt_scale=2), device="cpu",
                 rt_shadows=True, rt_reflections=True, taa=False, bloom=False)
    img = r.render_frame()
    assert r.cfg.rt_scale == 2 and img.shape == (16, 32, 3) and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="rt_scale"):
        dataclasses.replace(_cfg(), rt_scale=3)
    scene, cam = tproc.build_test_scene(viewport=(32, 16))
    rigid = scene.static_info()
    scene.static_info = lambda: dataclasses.replace(rigid, has_hair=True)
    r = Renderer(scene, cam, _cfg(), device="cpu", rt_reflections=True)
    assert [p.name for p in r.pipeline.passes][1:4] == ["Geometry", "SunShadow",
                                                         "VisibilityShading"]
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
