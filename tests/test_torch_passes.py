"""Per-pass parity of the port's frames with the JAX package's, at 96^2: the
bare forward slice (one frame; SkyView also at ``sky_fetch_scale`` 2 and 3
on the same input state, its colour within 1e-5), and the `forward` (TAA
+ Bloom), `full_post` (SSAO, Fog, MotionBlur, DepthOfField, Bloom, TAA,
FXAA, CAS) and `spot` (a shadow-casting spot light: LocalShadow) frames
over two frames with the camera moved between them, frame 0's persistent
state fed to frame 1.

The harness walks the JAX pipeline's passes in order (the walk of
``validate_frame``, each pass jitted on its own), feeds every torch pass the
JAX input state of that pass through the bridge, and compares every
resource the pass publishes. Each pass is held on its own, so differences
cannot compound from one pass to the next.

Tolerances (both sides are f32; XLA:CPU fuses and reassociates some
multiply-adds and evaluates pow/log/exp/sin with its own approximations,
eager torch rounds every operation and calls libm):
  * ids, masks, counters and host versions: equal;
  * Visibility: equal background masks, under 0.1 % of ids differing
    (exact depth ties between the two rasters);
  * depths (SceneDepth, ShadowMap.sun, ShadowMoments.sun): atol 1e-6;
  * geometry floats (vertex pool, setup, records): rtol 1e-5, atol 1e-5 —
    relative, because off-screen corners of clipped triangles sit
    thousands of pixels out, where one f32 ulp is ~2e-4;
  * colour resources: compared only where Visibility agrees, to the max-abs
    bound in COLOR_ATOL (a few hundred ulps of the resource's own scale);
  * resources behind a hard threshold, which flips on an ulp (FLIPS): a
    stated share of pixels may exceed the bound, by no more than a stated
    cap. SSAO is one of them and is held by its mean as well: see
    ``compare_flips``.
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
from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

# The tests run beside other workers: a few intra-op threads a process keep
# eager torch from spinning on cores it does not have.
torch.set_num_threads(2)

RES = 96
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
SKY_RATES = (2, 3)  # SkyView's reduced env-map fetch rates walked beside the full one
PASSES = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
          "SkyView", "Output"]

EXACT = {"geom.positions", "geom.normals", "geom.tangents", "vis.overflow",
         "SceneCoverage", "scene.version", "SunShadow.version"}
DEPTHS = {"SceneDepth", "ShadowMap.sun", "ShadowMoments.sun"}
GEOMETRY = {"geom.vtx_world", "vis.setup", "vis.records"}
COLOR_ATOL = {
    "SceneColor": 2e-4,       # pre-exposed HDR, values up to ~2
    "SceneNormal": 1e-5,      # unit vectors
    "SceneVelocity": 5e-4,    # pixels: the difference of two ~100 px
                              # positions (one ulp there is 7.6e-6)
    "SceneBaseColor": 1e-4,   # trilinear albedo in [0, 1]: the mip lerp
                              # weight comes from a log2 of the UV gradients
    "SceneMaterial": 1e-5,    # roughness, metallic, occlusion, subsurface
    "LDR": 1e-5,              # display-encoded [0, 1]
    "Metering.avgLum": 1e-5,  # scalar, ~0.3
}


def _torch_state(state: dict) -> dict:
    """The JAX frame state as the port holds it (copies, on the CPU)."""
    return bridge.frame_state_from_numpy(state, "cpu")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def compare(key, ours, ref, vis_agree):
    if key == "Visibility":
        a, b = _np(ours), _np(ref)
        np.testing.assert_array_equal(a == -1, b == -1)
        assert (a != b).mean() < 0.001, key
    elif key in EXACT:
        assert np.array_equal(_np(ours), _np(ref)), key
    elif key in DEPTHS:
        np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-6, rtol=0, err_msg=key)
    elif key in GEOMETRY:
        pairs = zip(ours, ref) if key == "vis.setup" else [(ours, ref)]
        for o, r in pairs:
            o, r = _np(o), _np(r)
            if np.issubdtype(r.dtype, np.floating):
                np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=key)
            else:
                np.testing.assert_array_equal(o, r, err_msg=key)
    else:
        o, r = _np(ours), _np(ref)
        if o.ndim >= 2 and vis_agree is not None:
            o, r = o[vis_agree], r[vis_agree]
        np.testing.assert_allclose(o, r, atol=COLOR_ATOL[key], rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def walk():
    """Run both pipelines pass by pass; returns {pass: (torch, jax) updates}."""
    jscene, jcam = j_build_test_scene(viewport=(RES, RES))
    tscene, _ = t_build_test_scene(viewport=(RES, RES))
    jcfg = JPipelineConfig(width=RES, height=RES, raster=JRasterConfig(**RASTER),
                           shadow_map_size=128, scene=jscene.static_info())
    tcfg = TPipelineConfig(width=RES, height=RES, raster=TRasterConfig(**RASTER),
                           shadow_map_size=128, scene=tscene.static_info())
    jpipe = j_make_pipeline(jcfg, taa=False, bloom=False)
    tpipe = t_make_pipeline(tcfg, taa=False, bloom=False, device="cpu")
    assert [n for n, _ in jpipe._executes] == PASSES == [n for n, _ in tpipe._executes]
    assert sorted(jpipe.registry.persistent_names) == sorted(tpipe.registry.persistent_names)

    jsa, jcs = jscene.build(), jcam.state(0)
    tctx = TFrameContext(
        scene=bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu"),
        camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
        frame_index=0, delta_time=1 / 60,
    )
    jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(0, jnp.int32),
                         delta_time=jnp.asarray(1 / 60, jnp.float32),
                         row_offset=jnp.zeros((), jnp.int32))
    # SkyView at the low fetch rates, on the same input state.
    low_rate = {k: (dict(t_make_pipeline(dataclasses.replace(tcfg, sky_fetch_scale=k),
                                         taa=False, bloom=False, device="cpu")._executes),
                    dict(j_make_pipeline(dataclasses.replace(jcfg, sky_fetch_scale=k),
                                         taa=False, bloom=False)._executes))
                for k in SKY_RATES}
    state = jpipe.initial_state()
    state["scene.version"] = jnp.asarray(0, jnp.int32)  # the first build, as Renderer
    out = {}
    for (name, jexec), (_, texec) in zip(jpipe._executes, tpipe._executes):
        tupd = texec(_torch_state(state), tctx)
        jupd = jax.jit(jexec)(state, jctx)
        out[name] = (tupd, jupd)
        if name == "SkyView":
            for k, (tlow, jlow) in low_rate.items():
                out[f"SkyView@{k}"] = (tlow[name](_torch_state(state), tctx),
                                       jax.jit(jlow[name])(state, jctx))
        state = {**state, **jupd}
    return out


@pytest.mark.parametrize("k", SKY_RATES)
def test_sky_fetch_scale_matches_jax(walk, k):
    """SkyView fetching the env map at 1/k rate and upsampling it: the
    colour within 1e-5 and the (full-rate) sky velocity as the walk holds
    it; the low-rate sky is not the full-rate one."""
    tupd, jupd = walk[f"SkyView@{k}"]
    assert set(tupd) == set(jupd) == {"SceneColor", "SceneVelocity"}
    np.testing.assert_allclose(_np(tupd["SceneColor"]), _np(jupd["SceneColor"]), atol=1e-5,
                               rtol=0)
    compare("SceneVelocity", tupd["SceneVelocity"], jupd["SceneVelocity"], None)
    full = _np(walk["SkyView"][0]["SceneColor"])
    assert np.abs(_np(tupd["SceneColor"]) - full).max() > 1e-4


@pytest.mark.parametrize("name", PASSES)
def test_pass_matches_jax(walk, name):
    tupd, jupd = walk[name]
    assert set(tupd) == set(jupd)
    vis_agree = None
    geo_t, geo_j = walk["Geometry"]
    if name != "Geometry":
        vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    for key in sorted(jupd):
        compare(key, tupd[key], jupd[key], vis_agree)
    if name == "Output":
        assert np.isfinite(_np(tupd["LDR"])).all()


# -- the frames of this slice: two frames, the camera moved between them -------

FRAME_PASSES = {
    "forward": ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
                "SkyView", "Bloom", "TAA", "Output"],
    "full_post": ["Scene", "Geometry", "SunShadow", "VisibilityShading", "SSAO",
                  "LightingCompose", "SkyView", "Fog", "MotionBlur", "DepthOfField", "Bloom",
                  "TAA", "Output", "FXAA", "CAS"],
    "spot": ["Scene", "Geometry", "SunShadow", "LocalShadow", "VisibilityShading",
             "LightingCompose", "SkyView", "Bloom", "TAA", "Output"],
}
FRAME_KW = {
    "forward": {},
    "full_post": dict(ssao=True, fog=True, motion_blur=True, depth_of_field=True, fxaa=True,
                      cas=True),
    "spot": {},
}
DEPTHS |= {"ShadowMap.locals"}
COLOR_ATOL |= {
    "TAAHistory": 2e-4,  # the SceneColor TAA publishes
    "SceneCoC": 1e-4,    # pixels, up to 16
}
# (pipeline, pass, resource) -> (bound, share of values allowed over it, cap on those).
FLIPS = {
    # The rotation hash decides each pixel's kernel and the occlusion test
    # flips whole samples; after the 3x3 blur most pixels still agree closely.
    ("full_post", "SSAO", "SSAO"): (1e-4, 0.01, 1.0),
    # FXAA's edge and direction tests flip on an ulp of luma.
    ("full_post", "FXAA", "LDR"): (1e-5, 0.005, 0.5),
    # PCF's depth compare flips a tap (1/8 of the spot's light), and the IES
    # lookup's index comes from an acos.
    ("spot", "VisibilityShading", "SceneColor"): (2e-4, 0.005, 2.0),
}


def compare_flips(key, ours, ref, bound, share, cap):
    o, r = _np(ours), _np(ref)
    diff = np.abs(o - r)
    assert (diff > bound).mean() < share, (key, float((diff > bound).mean()))
    assert diff.max() <= cap, (key, float(diff.max()))
    if key == "SSAO":
        assert abs(o.mean() - r.mean()) < 0.01, (o.mean(), r.mean())


def _spot_light(mod):
    return mod.SpotLight(position=np.array([0.5, 3.0, 1.0], np.float32),
                         direction=np.array([-0.2, -1.0, -0.1], np.float32),
                         luminous_intensity_cd=150000.0, cast_shadows=True)


def walk_frames(kind):
    """Both pipelines of ``kind`` pass by pass over two frames:
    {(frame, pass): (torch, jax) updates}."""
    import arkoserenderer_torch.scene.lights as tlights
    import arkoserenderer_tpu.scene.lights as jlights

    n_spheres = 1 if kind == "spot" else 3
    jscene, jcam = j_build_test_scene(viewport=(RES, RES), n_spheres=n_spheres)
    tscene, _ = t_build_test_scene(viewport=(RES, RES), n_spheres=n_spheres)
    if kind == "spot":
        jscene.spots.append(_spot_light(jlights))
        tscene.spots.append(_spot_light(tlights))
    sizes = dict(width=RES, height=RES, shadow_map_size=128, local_shadow_map_size=128)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    jpipe = j_make_pipeline(jcfg, **FRAME_KW[kind])
    tpipe = t_make_pipeline(tcfg, device="cpu", **FRAME_KW[kind])
    assert [n for n, _ in jpipe._executes] == FRAME_PASSES[kind] == [n for n, _ in tpipe._executes]
    persistent = sorted(jpipe.registry.persistent_names)
    assert persistent == sorted(tpipe.registry.persistent_names)
    assert "TAAHistory" in persistent

    jsa = jscene.build()
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes]
    state = jpipe.initial_state()
    out = {}
    for frame in (0, 1):
        if frame == 1:
            jcam.post_render()
            jcam.position = jcam.position + np.array([0.4, 0.0, 0.0], np.float32)
            state = {k: state[k] for k in persistent}   # what Renderer feeds back
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


@pytest.fixture(scope="module", params=sorted(FRAME_PASSES))
def frames(request):
    return request.param, walk_frames(request.param)


@pytest.mark.parametrize("frame", [0, 1])
def test_frames_match_jax(frames, frame):
    """Every published key of every pass of the pipeline, for one frame."""
    kind, out = frames
    geo_t, geo_j = out[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    for name in FRAME_PASSES[kind]:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            flips = FLIPS.get((kind, name, key))
            if flips is not None:
                compare_flips(key, tupd[key], jupd[key], *flips)
            else:
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    assert np.isfinite(_np(out[frame, FRAME_PASSES[kind][-1]][0]["LDR"])).all()


def test_frames_move_and_carry_history(frames):
    """The second frame really reprojects: the camera's move gives motion
    vectors of more than a pixel, TAA's history differs between the frames,
    and frame 1's TAA blended history in (its output is not its input)."""
    kind, out = frames
    vel = _np(out[1, "VisibilityShading"][0]["SceneVelocity"])
    assert np.abs(vel).max() > 1.0
    h0, h1 = (_np(out[f, "TAA"][0]["TAAHistory"]) for f in (0, 1))
    assert np.abs(h1 - h0).max() > 1e-3
    before_taa = FRAME_PASSES[kind][FRAME_PASSES[kind].index("TAA") - 1]
    assert np.abs(h1 - _np(out[1, before_taa][0]["SceneColor"])).max() > 1e-3
    if kind == "spot":
        locals_ = _np(out[1, "LocalShadow"][0]["ShadowMap.locals"])
        assert locals_.shape == (1, 128, 128) and (locals_ > 0).mean() > 0.2
