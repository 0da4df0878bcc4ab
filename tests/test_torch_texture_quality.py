"""The port's texture qualities and stochastic VSM tap against the JAX package.

* ``ops/mattex.sample_packed`` for aniso2, aniso4, stochastic and
  stochastic1 (and trilinear, bilinear, sorted and the stochastic
  qualities without noise, which fall back to bilinear) on one packed pool
  (a wrapped checkerboard and a clamped noise texture with a normal map),
  at 512 random uvs, gradients and blue-noise-like draws: every lane of
  every MaterialSample field within atol 1e-5 of JAX's. The stochastic
  picks (round(lod + u - 0.5), round(x + u - 0.5)) are compared first:
  the chosen mip and texel are computed from each side's inputs in float64
  and must not sit within 1e-4 of a rounding tie, so no pixel can flip
  between XLA and torch on these draws.
* The twins of ``tests/test_mattex_aniso.py``'s two cases on the port's
  own pool: aniso4 closer than trilinear to the footprint integral of a
  grazing footprint, and aniso4 within 0.06 of trilinear on a square one.
* ``ops/shadow.sample_vsm(taps="stochastic")`` against JAX's on random
  moments, world positions and draws: atol 1e-6 (a visibility in [0, 1]).
* Every pass of the forward frame with SSAO, MotionBlur and DepthOfField
  under ``texture_quality="stochastic1"`` and ``shadow_filter="stochastic"``
  over three frames (the camera moved between them, the frame's persistent
  state fed on), through ``tests/test_torch_passes.py``'s harness: each
  torch pass takes JAX's input state and every resource it publishes is
  held to ``compare``'s tolerances (``COLOR_ATOL``), SSAO to the harness's
  flip bound. In a frame the texel picks do sit near ties: the pixel's uv
  comes from barycentrics that XLA and torch round apart by ulps, so a pick
  within a few ulps of a tie flips to the neighbouring texel. The share of
  VisibilityShading's pixels off by more than COLOR_ATOL is bounded by
  STOCHASTIC_FLIPS (0.1 %, one pixel seen in 27,648 over the three frames),
  and each such pixel must be one whose pick, recomputed from the port's
  own sampler inputs, lies within 1e-3 of a tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_torch.assets.procedural import checkerboard_texture as t_checkerboard
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.ops import mattex as tm
from arkoserenderer_torch.ops import shadow as tshadow
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.scene.scene import Material as TMaterial
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene
from arkoserenderer_tpu.assets.procedural import checkerboard_texture
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.ops import mattex as jm
from arkoserenderer_tpu.ops import shadow as jshadow
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from arkoserenderer_tpu.scene.scene import Material as JMaterial
from test_torch_passes import FLIPS, RASTER, RES, _np, _torch_state, compare, compare_flips

torch.set_num_threads(2)

N = 512
ATOL = 1e-5          # MaterialSample lanes in [0, 1] (the normal in [-1, 1])
TIE_MARGIN = 1e-4    # no stochastic pick may sit this close to a rounding tie
QUALITIES = ["trilinear", "bilinear", "sorted", "aniso2", "aniso4", "stochastic",
             "stochastic1", "stochastic no noise", "stochastic1 no noise"]


def _pool():
    """(rows uint32, per-pixel meta, inputs) of a two-material pool: a
    wrapped 64^2 checkerboard, and a clamped 32^2 noise texture with a
    noise normal map; pixels alternate between them."""
    rng = np.random.default_rng(21)
    white = np.full((1, 1, 4), 255, np.uint8)
    noise = rng.integers(0, 256, (32, 32, 4)).astype(np.uint8)
    normal = rng.integers(64, 192, (32, 32, 4)).astype(np.uint8)
    images = [(white, False, 0)] * 4 + [(checkerboard_texture(64, 8), False, 0),
                                        (noise, False, 1), (normal, False, 1)]
    mats = [JMaterial(base_color_tex=4), JMaterial(base_color_tex=5, normal_tex=6)]
    rows, meta = jm.build_packed_materials(mats, images)
    uv = rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    # Footprints from 1/512 to 1/2 of the texture, isotropic and grazing.
    mag = np.exp(rng.uniform(np.log(1 / 512), np.log(0.5), (N, 2))).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, N).astype(np.float32)
    dx = np.stack([np.cos(ang), np.sin(ang)], -1) * mag[:, :1]
    dy = np.stack([-np.sin(ang), np.cos(ang)], -1) * mag[:, 1:]
    draws = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    meta_px = meta[np.arange(N) % 2]
    return rows, meta_px, (uv, dx.astype(np.float32), dy.astype(np.float32), draws)


@pytest.fixture(scope="module")
def pool():
    return _pool()


def _sample_both(pool, quality):
    rows, meta_px, (uv, dx, dy, draws) = pool
    q = quality.split()[0]
    with_noise = "no noise" not in quality and q.startswith("stochastic")
    noise = (draws if q == "stochastic1" else draws[:, 0]) if with_noise else None
    ours = tm.sample_packed(torch.from_numpy(rows.view(np.int32)), torch.from_numpy(meta_px),
                            *map(torch.from_numpy, (uv, dx, dy)), quality=q,
                            noise=None if noise is None else torch.from_numpy(noise))
    ref = jm.sample_packed(jnp.asarray(rows), jnp.asarray(meta_px),
                           *map(jnp.asarray, (uv, dx, dy)), quality=q,
                           noise=None if noise is None else jnp.asarray(noise))
    return ours, ref


def _stochastic_picks(meta_px, uv, dx, dy, draws):
    """float64 lod + u - 0.5 (the mip pick) and, at the picked mip, x + u -
    0.5 and y + u - 0.5 (stochastic1's texel pick), per pixel."""
    size0 = meta_px[:, 1:3].astype(np.float64)
    rho2 = np.maximum(((dx * size0) ** 2).sum(-1), ((dy * size0) ** 2).sum(-1))
    lod = np.clip(0.5 * np.log2(np.maximum(rho2, 1e-12)), 0.0, meta_px[:, 3] - 1.0)
    lod_j = np.clip(lod + draws[:, 0] - 0.5, 0.0, meta_px[:, 3] - 1.0)
    level = np.round(lod_j).astype(int)
    w = np.maximum(meta_px[:, 1].astype(int) >> level, 1)
    h = np.maximum(meta_px[:, 2].astype(int) >> level, 1)
    x = uv[:, 0] * w - 0.5 + (draws[:, 1] - 0.5)
    y = uv[:, 1] * h - 0.5 + (draws[:, 2] - 0.5)
    return lod_j, x, y


def test_stochastic_picks_keep_clear_of_ties(pool):
    """No pick of these draws lies within TIE_MARGIN of a .5 tie, so an ulp
    between XLA's and torch's lod or texel coordinate cannot flip it; the
    comparisons below then hold every pixel."""
    assert _tie_distance(_stochastic_picks(pool[1], *pool[2])).min() > TIE_MARGIN


def _tie_distance(picks) -> np.ndarray:
    """Per pixel, how far the nearest of its picks lies from a .5 tie."""
    return np.min([np.abs(v - np.floor(v) - 0.5) for v in picks], axis=0)


@pytest.mark.parametrize("quality", QUALITIES)
def test_sample_packed_matches_jax(pool, quality):
    ours, ref = _sample_both(pool, quality)
    for field in ref._fields:
        np.testing.assert_allclose(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
                                   atol=ATOL, rtol=0, err_msg=f"{quality} {field}")


def test_stochastic_qualities_differ_from_trilinear_and_fall_back(pool):
    """The qualities really take their own branch: the jittered picks
    differ from trilinear somewhere, and without noise the stochastic
    qualities are bilinear, bit for bit."""
    tri = _sample_both(pool, "trilinear")[0].base
    bil = _sample_both(pool, "bilinear")[0].base
    for q in ("stochastic", "stochastic1", "aniso4"):
        assert (_sample_both(pool, q)[0].base - tri).abs().max() > 1e-2, q
    for q in ("stochastic no noise", "stochastic1 no noise"):
        assert torch.equal(_sample_both(pool, q)[0].base, bil), q


# -- the twins of tests/test_mattex_aniso.py ---------------------------------------

CHECKER_ID = 4  # ids 0-3 are the pool's reserved defaults


def _port_images():
    white = np.full((1, 1, 4), 255, np.uint8)
    return [(white, False, 0)] * CHECKER_ID + [(t_checkerboard(64, 8), False, 0)]


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _bilinear(img, u, v):
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0

    def at(xi, yi):
        return _srgb_to_linear(img[yi % h, xi % w, :3].astype(np.float64) / 255.0)

    return (at(x0, y0) * (1 - fx) * (1 - fy) + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy + at(x0 + 1, y0 + 1) * fx * fy)


def _port_sample(rows, meta_px, uv, d_x, d_y, quality):
    ms = tm.sample_packed(torch.from_numpy(rows.view(np.int32)), torch.from_numpy(meta_px),
                          torch.from_numpy(uv), torch.from_numpy(d_x), torch.from_numpy(d_y),
                          quality=quality)
    return ms.base.numpy().astype(np.float64)


def test_aniso_beats_trilinear_on_grazing_footprints():
    imgs = _port_images()
    rows, meta = tm.build_packed_materials([TMaterial(base_color_tex=CHECKER_ID)], imgs)
    rng = np.random.default_rng(5)
    n = 48
    uv = rng.uniform(0.25, 0.75, (n, 2)).astype(np.float32)
    duv_dx = np.tile(np.array([0.25, 0.0], np.float32), (n, 1))
    duv_dy = np.tile(np.array([0.0, 0.02], np.float32), (n, 1))
    meta_px = np.tile(meta[0], (n, 1))
    tri = _port_sample(rows, meta_px, uv, duv_dx, duv_dy, "trilinear")[:, :3]
    a4 = _port_sample(rows, meta_px, uv, duv_dx, duv_dy, "aniso4")[:, :3]

    checker = imgs[CHECKER_ID][0]
    truth = np.zeros((n, 3))
    ss, ts = np.linspace(-0.5, 0.5, 33), np.linspace(-0.5, 0.5, 9)
    for i in range(n):
        acc = np.zeros(3)
        for s in ss:
            for t in ts:
                acc += _bilinear(checker, uv[i, 0] + s * duv_dx[i, 0], uv[i, 1] + t * duv_dy[i, 1])
        truth[i] = acc / (len(ss) * len(ts))
    err_tri = np.abs(tri - truth).mean()
    err_a4 = np.abs(a4 - truth).mean()
    assert err_a4 < err_tri * 0.75, (err_a4, err_tri)
    assert err_a4 < 0.08, err_a4


def test_aniso_matches_trilinear_on_isotropic_footprints():
    rows, meta = tm.build_packed_materials([TMaterial(base_color_tex=CHECKER_ID)],
                                           _port_images())
    rng = np.random.default_rng(6)
    n = 48
    uv = rng.uniform(0.2, 0.8, (n, 2)).astype(np.float32)
    d = np.tile(np.array([0.03, 0.0], np.float32), (n, 1))
    dy = np.tile(np.array([0.0, 0.03], np.float32), (n, 1))
    meta_px = np.tile(meta[0], (n, 1))
    tri = _port_sample(rows, meta_px, uv, d, dy, "trilinear")
    a4 = _port_sample(rows, meta_px, uv, d, dy, "aniso4")
    assert np.abs(tri - a4).max() < 0.06, np.abs(tri - a4).max()


# -- the stochastic VSM tap ----------------------------------------------------------

def test_sample_vsm_stochastic_matches_jax():
    rng = np.random.default_rng(8)
    s, n = 64, 4096
    mean = rng.uniform(0.2, 0.8, (s, s)).astype(np.float32)
    moments = np.stack([mean, mean * mean + rng.uniform(0, 1e-3, (s, s))], -1).astype(np.float32)
    vp = np.array([[0.8, 0.0, 0.1, 0.0], [0.0, 0.8, -0.1, 0.0], [0.0, 0.1, 0.3, 0.5],
                   [0.0, 0.0, 0.0, 1.0]], np.float32)
    world = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    n_dot_l = rng.uniform(0.0, 1.0, n).astype(np.float32)
    noise2 = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    args = (moments, vp, world, n_dot_l)
    ours = tshadow.sample_vsm(*map(torch.from_numpy, args), taps="stochastic",
                              noise2=torch.from_numpy(noise2)).numpy()
    ref = np.asarray(jshadow.sample_vsm(*map(jnp.asarray, args), taps="stochastic",
                                        noise2=jnp.asarray(noise2)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    bil = tshadow.sample_vsm(*map(torch.from_numpy, args)).numpy()
    inside = (ours < 1.0) | (bil < 1.0)
    assert inside.mean() > 0.3 and np.abs(ours - bil).max() > 1e-3  # its own branch


# -- three frames of the stochastic frame, pass by pass ------------------------------

WALK_KW = dict(ssao=True, motion_blur=True, depth_of_field=True)
WALK_PASSES = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "SSAO", "LightingCompose",
               "SkyView", "MotionBlur", "DepthOfField", "Bloom", "TAA", "Output"]
STOCHASTIC = dict(texture_quality="stochastic1", shadow_filter="stochastic")
# VisibilityShading's resources a flipped texel pick moves: (bound, share of
# pixels allowed over it, cap on those).
STOCHASTIC_FLIPS = {"SceneBaseColor": (1e-4, 0.001, 1.0), "SceneColor": (2e-4, 0.001, 4.0),
                    "SceneMaterial": (1e-5, 0.001, 1.0), "SceneNormal": (1e-5, 0.001, 2.0)}
FLIP_TIE = 1e-3  # a flipped pixel's pick lies this close to a tie


def walk_stochastic(frames: int = 3):
    """Both pipelines pass by pass over ``frames`` frames: {(frame, pass):
    (torch, jax) updates}."""
    jscene, jcam = j_build_test_scene(viewport=(RES, RES))
    tscene, _ = t_build_test_scene(viewport=(RES, RES))
    sizes = dict(width=RES, height=RES, shadow_map_size=128, **STOCHASTIC)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    jpipe = j_make_pipeline(jcfg, **WALK_KW)
    tpipe = t_make_pipeline(tcfg, device="cpu", **WALK_KW)
    assert [n for n, _ in jpipe._executes] == WALK_PASSES == [n for n, _ in tpipe._executes]
    persistent = sorted(jpipe.registry.persistent_names)
    assert persistent == sorted(tpipe.registry.persistent_names)
    jsa = jscene.build()
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes]
    state = jpipe.initial_state()
    out = {}
    sampled = []  # the port's sampler inputs, one call a frame
    sample_packed = tm.sample_packed

    def recording(rows, meta, uv, duv_dx, duv_dy, **kw):
        sampled.append((meta, uv, duv_dx, duv_dy, kw["noise"]))
        return sample_packed(rows, meta, uv, duv_dx, duv_dy, **kw)

    tm.sample_packed = recording
    try:
        for frame in range(frames):
            if frame:
                jcam.post_render()
                jcam.position = jcam.position + np.array([0.4, 0.0, 0.0], np.float32)
                state = {k: state[k] for k in persistent}
            state["scene.version"] = jnp.asarray(0, jnp.int32)
            jcs = jcam.state(frame)
            tctx = TFrameContext(scene=tsa,
                                 camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                                 frame_index=frame, delta_time=1 / 60)
            jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(frame, jnp.int32),
                                 delta_time=jnp.asarray(1 / 60, jnp.float32),
                                 row_offset=jnp.zeros((), jnp.int32))
            for (name, _), jexec, (_, texec) in zip(jpipe._executes, jitted, tpipe._executes):
                tupd = texec(_torch_state(state), tctx)
                jupd = jexec(state, jctx)
                out[frame, name] = (tupd, jupd)
                state = {**state, **jupd}
    finally:
        tm.sample_packed = sample_packed
    assert len(sampled) == frames
    out["sampled"] = [tuple(_np(x) for x in call) for call in sampled]
    return out


@pytest.fixture(scope="module")
def stochastic_walk():
    return walk_stochastic()


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_stochastic_frames_match_jax(stochastic_walk, frame):
    out = stochastic_walk
    geo_t, geo_j = out[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    for name in WALK_PASSES:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            flips = FLIPS.get(("full_post", name, key))
            if name == "VisibilityShading" and key in STOCHASTIC_FLIPS:
                flips = STOCHASTIC_FLIPS[key]
            if flips is not None:
                compare_flips(key, tupd[key], jupd[key], *flips)
            else:
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    assert np.isfinite(_np(out[frame, "Output"][0]["LDR"])).all()


def test_stochastic_flips_sit_at_ties(stochastic_walk):
    """Every VisibilityShading pixel whose albedo differs from JAX's is one
    whose stochastic pick (mip or texel, recomputed in float64 from the
    port's sampler inputs) lies within FLIP_TIE of a rounding tie."""
    for frame in range(3):
        tupd, jupd = stochastic_walk[frame, "VisibilityShading"]
        diff = np.abs(_np(tupd["SceneBaseColor"]) - _np(jupd["SceneBaseColor"])).max(-1)
        flipped = diff.reshape(-1) > STOCHASTIC_FLIPS["SceneBaseColor"][0]
        meta, uv, dx, dy, noise = stochastic_walk["sampled"][frame]
        ties = _tie_distance(_stochastic_picks(meta, uv, dx, dy, noise))
        assert (ties[flipped] < FLIP_TIE).all(), (frame, ties[flipped])


def test_stochastic_frames_change_with_the_frame(stochastic_walk):
    """The draws are the frame's: VisibilityShading's albedo (one texel a
    pixel from a jittered mip) changes between frames 0 and 2 where the
    camera's move leaves the same surface under most pixels."""
    b0 = _np(stochastic_walk[0, "VisibilityShading"][0]["SceneBaseColor"])
    b2 = _np(stochastic_walk[2, "VisibilityShading"][0]["SceneBaseColor"])
    assert np.abs(b2 - b0).max() > 1e-2
