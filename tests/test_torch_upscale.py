"""The port's upscaling against the JAX package's: the render-resolution
presets, the two rational resizes, the spatial Upscale pass, and the
TemporalUpscale pass inside the `forward_upscaled` frame over three frames
of a moving camera and one still frame; and the pass order of
``make_forward_pipeline(upscale_to=...)`` in both modes.

Tolerances:
  * presets: equal;
  * the resizes: 1e-6 on images in [0, 1] (a lerp of two or four taps with
    f32 weights; XLA may fuse a multiply-add that torch rounds twice);
  * the Upscale pass: 1e-5 (the resize, then CAS's reciprocal and square
    root);
  * the forward_upscaled walk: each pass fed the JAX input state, held by
    tests/test_torch_passes.py's rules, the raster setup and records as
    tests/test_torch_stress.py holds them (floats on the rows both rasters
    take; here one row in 36,864 may be taken by one side only: a triangle
    on the edge of a cull test after the camera moved). LDRDisplay and
    UpscaleHistory (display resolution, values in [0, 1]) by a share of
    values and a cap (DISPLAY_FLIPS): the history clamp's sigma is the
    square root of m2/9 - m1^2, a difference of two nearly equal f32 sums,
    so in a flat neighbourhood an ulp of either becomes a sigma of ~1e-4,
    which the clamp passes on times gamma (up to 4) and CAS sharpens. The
    port and the reference are each as far from a float64 evaluation of
    the pass as from each other (``test_upscale_difference_is_f32_rounding``).
  * the reprojection: both packages take nine sub-pixel shifts when the
    frame's largest display-space motion is at most a pixel, a branch on a
    device value, and the bilinear gather otherwise
    (tests/test_torch_history_branches.py holds the branch). The two are
    the same interpolation summed in another order: equal at zero motion
    (frame 0, and a still camera whose jitter alone moves), and within
    FAST_BRANCH_ATOL at sub-pixel motion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.ops import image as timage
from arkoserenderer_torch.ops import upscale as tupscale
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.ops import image as jimage
from arkoserenderer_tpu.ops import upscale as jupscale
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_passes import _np, _torch_state, compare, compare_flips
from test_torch_stress import compare_taken_rows, taken_rows

torch.set_num_threads(2)

DISPLAY, RENDER = 96, 64  # the "quality" preset of a 96^2 display
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
# resource -> (bound, share of values allowed over it, cap on those)
DISPLAY_FLIPS = {"LDRDisplay": (2e-5, 0.05, 2e-3), "UpscaleHistory": (2e-5, 0.05, 2e-3)}
FAST_BRANCH_ATOL = 1e-6
UPSCALED = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
            "SkyView", "Bloom", "Output", "TemporalUpscale"]


@pytest.mark.parametrize("quality", ["quality", "balanced", "performance"])
def test_ideal_render_resolution_matches_jax(quality):
    for w, h in ((1920, 1080), (2560, 1440), (3840, 2160), (1280, 720), (96, 96), (1000, 700)):
        ours = tupscale.ideal_render_resolution(w, h, quality)
        assert ours == jupscale.ideal_render_resolution(w, h, quality), (w, h)
        assert ours[0] % 8 == 0 and ours[1] % 8 == 0
    assert tupscale.ideal_render_resolution(1920, 1080, quality) == {
        "quality": (1280, 720), "balanced": (1152, 648), "performance": (960, 536)}[quality]


RATIOS = {"2/3": ((48, 80), (72, 120)), "3/5": ((36, 60), (60, 100)), "1/2": ((40, 64), (80, 128))}


@pytest.mark.parametrize("ratio", sorted(RATIOS))
def test_rational_resizes_match_jax(ratio):
    """Both resizes at render/display ratios 2/3, 3/5 and 1/2, the jittered
    one at two nonzero jitters, on a random 3-channel image."""
    (h, w), (oh, ow) = RATIOS[ratio]
    img = np.random.default_rng(5).random((h, w, 3), dtype=np.float32)
    ours = timage.resize_bilinear_rational(torch.from_numpy(img), oh, ow).numpy()
    ref = np.asarray(jimage.resize_bilinear_rational(jnp.asarray(img), oh, ow))
    assert ours.shape == (oh, ow, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    for jx, jy in ((0.3125, -0.1875), (-0.45, 0.4)):
        ours = timage.resize_bilinear_rational_jittered(
            torch.from_numpy(img), oh, ow, torch.tensor(jx), torch.tensor(jy)).numpy()
        ref = np.asarray(jimage.resize_bilinear_rational_jittered(
            jnp.asarray(img), oh, ow, jnp.float32(jx), jnp.float32(jy)))
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    same = timage.resize_bilinear_rational_jittered(
        torch.from_numpy(img), h, w, torch.tensor(0.25), torch.tensor(0.0)).numpy()
    assert not np.allclose(same, img)  # an equal size still shifts by the jitter


def test_upscale_pass_matches_jax():
    """UpscalePass (spatial) on one LDR image: LDRDisplay within 1e-5."""
    from arkoserenderer_torch.rendering.passes.upscale import UpscalePass as TUpscalePass
    from arkoserenderer_torch.rendering.registry import Registry as TRegistry
    from arkoserenderer_tpu.rendering.passes.upscale import UpscalePass as JUpscalePass
    from arkoserenderer_tpu.rendering.registry import Registry as JRegistry

    ldr = np.random.default_rng(9).random((RENDER, RENDER, 3), dtype=np.float32)
    treg, jreg = TRegistry(), JRegistry()
    treg.create("LDR", (RENDER, RENDER, 3), torch.float32)
    jreg.create("LDR", (RENDER, RENDER, 3), jnp.float32)
    tcfg = TPipelineConfig(width=RENDER, height=RENDER)
    jcfg = JPipelineConfig(width=RENDER, height=RENDER)
    texec = TUpscalePass(DISPLAY, DISPLAY).construct(tcfg, treg, torch.device("cpu"))
    jexec = JUpscalePass(DISPLAY, DISPLAY).construct(jcfg, jreg)
    ours = texec({"LDR": torch.from_numpy(ldr)}, None)["LDRDisplay"].numpy()
    ref = np.asarray(jax.jit(jexec)({"LDR": jnp.asarray(ldr)}, None)["LDRDisplay"])
    assert ours.shape == (DISPLAY, DISPLAY, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


# Camera moves before each frame: three frames of motion, then a still one.
MOVES = {0: None, 1: (0.4, 0.0, 0.0), 2: (0.0, 0.0, -0.3), 3: (0.0, 0.0, 0.0)}


def walk_upscaled():
    """Both forward_upscaled pipelines pass by pass over MOVES' frames;
    {(frame, pass): (torch, jax) updates}, and the JAX pipeline."""
    jscene, jcam = j_build_test_scene(viewport=(RENDER, RENDER))
    tscene, _ = t_build_test_scene(viewport=(RENDER, RENDER))
    sizes = dict(width=RENDER, height=RENDER, shadow_map_size=128)
    jpipe = j_make_pipeline(JPipelineConfig(raster=JRasterConfig(**RASTER),
                                            scene=jscene.static_info(), **sizes),
                            upscale_to=(DISPLAY, DISPLAY))
    tpipe = t_make_pipeline(TPipelineConfig(raster=TRasterConfig(**RASTER),
                                            scene=tscene.static_info(), **sizes),
                            upscale_to=(DISPLAY, DISPLAY), device="cpu")
    assert [n for n, _ in jpipe._executes] == UPSCALED == [n for n, _ in tpipe._executes]
    assert tpipe.cfg.mip_bias == jpipe.cfg.mip_bias == np.log2(RENDER / DISPLAY)
    persistent = sorted(jpipe.registry.persistent_names)
    assert persistent == sorted(tpipe.registry.persistent_names)
    assert "UpscaleHistory" in persistent and "TAAHistory" not in persistent

    jsa = jscene.build()
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes]
    state = jpipe.initial_state()
    out = {}
    for frame, move in MOVES.items():
        if move is not None:
            jcam.post_render()
            jcam.position = jcam.position + np.array(move, np.float32)
            state = {k: state[k] for k in persistent}
        state["scene.version"] = jnp.asarray(0, jnp.int32)
        jcs = jcam.state(frame)
        tctx = TFrameContext(scene=tsa, camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                             frame_index=frame, delta_time=1 / 60)
        jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(frame, jnp.int32),
                             delta_time=jnp.asarray(1 / 60, jnp.float32),
                             row_offset=jnp.zeros((), jnp.int32))
        for (name, _), jexec, (_, texec) in zip(jpipe._executes, jitted, tpipe._executes):
            if name == "TemporalUpscale":
                out[frame, "inputs"] = (_torch_state(state), tctx)
            out[frame, name] = (texec(_torch_state(state), tctx), jexec(state, jctx))
            state = {**state, **out[frame, name][1]}
    return out


@pytest.fixture(scope="module")
def upscaled_walk():
    return walk_upscaled()


def display_motion(out, frame):
    """The largest display-space motion of ``frame`` as the reference forms
    it (the value its reprojection branches on)."""
    vel = out[frame, "VisibilityShading"][1]["SceneVelocity"]
    vel = jimage.resize_bilinear_rational(vel, DISPLAY, DISPLAY) * (DISPLAY / RENDER)
    return float(jnp.max(jnp.sqrt(jnp.sum(vel * vel, axis=-1))))


@pytest.mark.parametrize("frame", sorted(MOVES))
def test_forward_upscaled_matches_jax(upscaled_walk, frame):
    """Every published key of every pass; the display-size resources by
    DISPLAY_FLIPS; frames 1-2 take the reference's general branch, frames 0
    and 3 its nine-shift branch (no motion)."""
    out = upscaled_walk
    geo_t, geo_j = out[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    valid = taken_rows(geo_t["vis.setup"], geo_j["vis.setup"], flips=1)
    for name in UPSCALED:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            if key in DISPLAY_FLIPS:
                assert tupd[key].shape == (DISPLAY, DISPLAY, 3)
                compare_flips(key, tupd[key], jupd[key], *DISPLAY_FLIPS[key])
            elif key in ("vis.setup", "vis.records"):
                compare_taken_rows(key, tupd[key], jupd[key], valid)
            else:
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    motion = display_motion(out, frame)
    assert (motion > 1.0) == (frame in (1, 2)), motion
    if frame in (0, 3):
        assert motion == 0.0


@pytest.mark.parametrize("frame", [1, 3])
def test_upscale_difference_is_f32_rounding(upscaled_walk, frame):
    """The port's TemporalUpscale run in float64 on the same inputs: the
    port's and the reference's float32 results are each about as far from
    it as from each other, so their distance is the float32 evaluation's
    own error (see the module docstring), not a different function."""
    inputs, ctx = upscaled_walk[frame, "inputs"]
    ours, ref = (upscaled_walk[frame, "TemporalUpscale"][i] for i in (0, 1))
    from arkoserenderer_torch.rendering.passes.upscale import TemporalUpscalePass
    from arkoserenderer_torch.rendering.registry import Registry

    reg = Registry()
    reg.create("LDR", (RENDER, RENDER, 3), torch.float32)
    reg.create("SceneVelocity", (RENDER, RENDER, 2), torch.float32)
    cfg = TPipelineConfig(width=RENDER, height=RENDER)
    execute = TemporalUpscalePass(DISPLAY, DISPLAY).construct(cfg, reg, torch.device("cpu"))
    wide = {k: inputs[k].double() for k in ("LDR", "SceneVelocity", "UpscaleHistory")}
    exact = execute(wide, ctx._replace(camera=ctx.camera._replace(
        jitter_px=ctx.camera.jitter_px.double())))
    for key in DISPLAY_FLIPS:
        e = exact[key].numpy()
        d_ours, d_ref = np.abs(_np(ours[key]) - e).max(), np.abs(_np(ref[key]) - e).max()
        d_both = np.abs(_np(ours[key]) - _np(ref[key])).max()
        assert d_both <= 2.0 * max(d_ours, d_ref), (key, d_both, d_ours, d_ref)
        assert max(d_ours, d_ref) < DISPLAY_FLIPS[key][2], key


def test_history_accumulates(upscaled_walk):
    """UpscaleHistory moves between frames and LDRDisplay is its clipped,
    sharpened view; the still frame blends (its output is not its input)."""
    out = upscaled_walk
    hist = [_np(out[f, "TemporalUpscale"][0]["UpscaleHistory"]) for f in sorted(MOVES)]
    assert all(np.abs(b - a).max() > 1e-3 for a, b in zip(hist, hist[1:]))
    disp = _np(out[3, "TemporalUpscale"][0]["LDRDisplay"])
    assert np.isfinite(disp).all() and 0.0 <= disp.min() and disp.max() <= 1.0


@pytest.mark.parametrize("max_offset", [0.0, 0.5, 1.0])
def test_bilinear_gather_against_nine_shift_branch(upscaled_walk, max_offset):
    """The port's bilinear gather (the reprojection past a pixel of motion)
    against the reference's nine-shift branch on frame 2's UpscaleHistory at
    offsets up to ``max_offset`` pixels: equal at zero offset,
    FAST_BRANCH_ATOL above."""
    hist = np.array(upscaled_walk[2, "TemporalUpscale"][1]["UpscaleHistory"])
    rng = np.random.default_rng(3)
    ox, oy = (rng.uniform(-max_offset, max_offset, (DISPLAY, DISPLAY)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(jimage.bilinear_sample_small_offset(jnp.asarray(hist), jnp.asarray(ox),
                                                         jnp.asarray(oy)))
    ys, xs = np.meshgrid(np.arange(DISPLAY, dtype=np.float32) + 0.5,
                         np.arange(DISPLAY, dtype=np.float32) + 0.5, indexing="ij")
    ours = timage.bilinear_sample(torch.from_numpy(hist), torch.from_numpy((xs + ox).ravel()),
                                  torch.from_numpy((ys + oy).ravel())).numpy()
    diff = np.abs(ours.reshape(DISPLAY, DISPLAY, 3) - ref)
    if max_offset == 0.0:
        assert diff.max() == 0.0
    else:
        assert diff.max() < FAST_BRANCH_ATOL, diff.max()


@pytest.mark.parametrize("mode", ["temporal", "spatial"])
def test_upscaled_pass_order_matches_jax(mode):
    """make_forward_pipeline(upscale_to=...) in both modes, with the default
    flags and with FXAA + CAS: the reference's passes in its order (the
    temporal upscale drops TAA), and the mip bias."""
    cfg_kw = dict(width=32, height=16, shadow_map_size=32)
    tcfg = TPipelineConfig(raster=TRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64),
                           **cfg_kw)
    jcfg = JPipelineConfig(raster=JRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64),
                           **cfg_kw)
    for extra in ({}, dict(fxaa=True, cas=True), dict(taa=False)):
        kw = dict(upscale_to=(48, 24), upscale_mode=mode, **extra)
        tp = t_make_pipeline(tcfg, device="cpu", **kw)
        jp = j_make_pipeline(jcfg, **kw)
        assert [p.name for p in tp.passes] == [p.name for p in jp.passes], extra
        assert tp.cfg.mip_bias == jp.cfg.mip_bias == np.log2(32 / 48)
    names = [p.name for p in t_make_pipeline(tcfg, device="cpu", upscale_to=(48, 24),
                                             upscale_mode=mode).passes]
    assert names[-1] == {"temporal": "TemporalUpscale", "spatial": "Upscale"}[mode]
    assert ("TAA" in names) == (mode == "spatial")
    biased = dataclasses.replace(tcfg, mip_bias=-0.25)
    assert t_make_pipeline(biased, device="cpu", upscale_to=(48, 24)).cfg.mip_bias == -0.25
