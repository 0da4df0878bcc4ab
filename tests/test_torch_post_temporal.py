"""The port's temporal post branches against the JAX package's, over frames
0-2 (each frame draws its own noise), on the synthetic 64x96 G-buffer of
``tests/test_torch_post_ops.py``:

* ``ops/postprocess._white_pixel_noise``, the reference's uint32 hash in
  int64 words: bit for bit, at frames 0, 1, 7 and 2^20, salts 0 and 5;
* ``ops/postprocess._pixel_noise`` (blue noise): bit for bit;
* ``ops/ssao.ssao(samples_per_frame=4)`` with the reference's rotation fed
  in (see test_torch_post_ops.py's SSAO test for why): the hashed kernel
  rows are integer arithmetic, so they agree exactly, but the occlusion
  test ``scene_z < sample_z - bias`` flips on an ulp, and one flipped
  sample moves a pixel by 4/16. Under 1 % of pixels may be off by more
  than 1e-4, and the means agree within 0.01;
* ``motion_blur(stochastic=True)`` (2 taps) and ``depth_of_field(
  stochastic_taps=4)``: each tap is one nearest fetch at a jittered
  coordinate, round(x - 0.5); a coordinate XLA and torch round apart by an
  ulp at a .5 tie fetches the neighbouring pixel. Colours (up to ~20) are
  held to atol 2e-5 on all but 0.5 % of pixels;
* SSSS's temporal branch (``SSSSPass(temporal=True)``: 4 rotated taps)
  on the same G-buffer with a subsurface disc, through both passes' execute
  callbacks: the same share bound, and pixels without subsurface equal to
  the input bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.ops import postprocess as tpp
from arkoserenderer_torch.ops import ssao as tssao
from arkoserenderer_tpu.ops import postprocess as jpp
from arkoserenderer_tpu.ops import ssao as jssao
from test_torch_post_ops import NEAR, H, J, T, W, frame  # noqa: F401 (the fixture)

torch.set_num_threads(2)

FRAMES = [0, 1, 2]
TAP_ATOL = 2e-5     # colours of order 1 (up to ~20), a few taps summed and divided
TAP_FLIPS = 0.005   # share of pixels a tie may move to a neighbouring texel


def held_with_flips(ours, ref, atol=TAP_ATOL, share=TAP_FLIPS):
    """All but ``share`` of the pixels within ``atol``; returns the share."""
    diff = np.abs(ours.numpy() - np.asarray(ref)).reshape(H * W, -1).max(-1)
    off = (diff > atol).mean()
    assert off < share, off
    return off


@pytest.mark.parametrize("frame_index", [0, 1, 7, 1 << 20])
def test_white_pixel_noise_bit_for_bit(frame, frame_index):
    for salt in (0, 5):
        ours = tpp._white_pixel_noise(T(frame["px"]), T(frame["py"]), frame_index, salt)
        ref = jpp._white_pixel_noise(J(frame["px"]), J(frame["py"]), jnp.asarray(frame_index),
                                     salt)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert 0.0 <= float(ours.min()) and float(ours.max()) < 1.0


@pytest.mark.parametrize("frame_index", FRAMES)
def test_blue_pixel_noise_bit_for_bit(frame, frame_index):
    for salt in (11, 41, 61):
        ours = tpp._pixel_noise(T(frame["px"]), T(frame["py"]), frame_index, salt)
        ref = jpp._pixel_noise(J(frame["px"]), J(frame["py"]), jnp.asarray(frame_index), salt)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_nearest_sample_matches_jax(frame):
    """The stochastic taps' fetch, at coordinates clear of ties and off the
    image on every side: bit for bit."""
    rng = np.random.default_rng(3)
    x = (np.floor(rng.uniform(-8, W + 8, H * W)) + rng.uniform(0.05, 0.45, H * W)
         * rng.choice([-1, 1], H * W) + 0.5).astype(np.float32)
    y = (np.floor(rng.uniform(-8, H + 8, H * W)) + 0.5).astype(np.float32)
    ours = tpp._nearest_sample(T(frame["color"]), T(x), T(y))
    ref = jpp._nearest_sample(J(frame["color"]), J(x), J(y))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("frame_index", FRAMES)
def test_temporal_ssao_matches_jax(frame, frame_index):
    f = frame
    kernel = tssao.make_ssao_kernel(16)
    args = (f["depth"], f["nrm"].reshape(-1, 3), f["valid"].ravel(), f["px"], f["py"], f["vp"])
    ref = jssao.ssao(*(J(a) for a in args), J(np.float32(NEAR)), W, H, kernel,
                     samples_per_frame=4, frame_index=jnp.asarray(frame_index, jnp.int32))
    angle = (J(f["px"]) * 12.9898 + J(f["py"]) * 78.233) * 43758.5453
    angle = (angle - jnp.floor(angle)) * (2.0 * jnp.pi)
    rot = (T(np.asarray(jnp.cos(angle))), T(np.asarray(jnp.sin(angle))))
    ours = tssao.ssao(*(T(a) for a in args), torch.tensor(NEAR), W, H, kernel, rotation=rot,
                      samples_per_frame=4, frame_index=frame_index)
    o, r = ours.numpy(), np.asarray(ref)
    assert (np.abs(o - r) > 1e-4).mean() < 0.01
    assert abs(o.mean() - r.mean()) < 0.01
    dense = tssao.ssao(*(T(a) for a in args), torch.tensor(NEAR), W, H, kernel, rotation=rot)
    assert np.abs(o - dense.numpy()).max() > 0.1  # a subset of the kernel, not all of it


def test_temporal_ssao_rows_change_with_the_frame(frame):
    """The hash picks other kernel rows in another frame."""
    f = frame
    kernel = tssao.make_ssao_kernel(16)
    args = [T(a) for a in (f["depth"], f["nrm"].reshape(-1, 3), f["valid"].ravel(), f["px"],
                           f["py"], f["vp"])]
    a, b = (tssao.ssao(*args, torch.tensor(NEAR), W, H, kernel, samples_per_frame=4,
                       frame_index=i) for i in (0, 1))
    assert (a - b).abs().max() > 0.1


@pytest.mark.parametrize("frame_index", FRAMES)
def test_stochastic_motion_blur_matches_jax(frame, frame_index):
    f = frame
    ours = tpp.motion_blur(T(f["color"]), T(f["vel"]), T(f["depth"]), num_taps=2,
                           stochastic=True, frame_index=frame_index)
    ref = jpp.motion_blur(J(f["color"]), J(f["vel"]), J(f["depth"]), num_taps=2,
                          stochastic=True, frame_index=jnp.asarray(frame_index, jnp.int32))
    held_with_flips(ours, ref)
    assert np.abs(ours.numpy() - f["color"]).max() > 0.1  # it did blur


@pytest.mark.parametrize("frame_index", FRAMES)
def test_stochastic_depth_of_field_matches_jax(frame, frame_index):
    f = frame
    coc = np.asarray(jpp.compute_coc(J(f["depth"]), J(f["valid"]), J(np.float32(NEAR)),
                                     J(np.float32(5.0)), J(np.float32(40.0))))
    ours = tpp.depth_of_field(T(f["color"]), T(coc), num_taps=24, stochastic_taps=4,
                              frame_index=frame_index)
    ref = jpp.depth_of_field(J(f["color"]), J(coc), num_taps=24, stochastic_taps=4,
                             frame_index=jnp.asarray(frame_index, jnp.int32))
    held_with_flips(ours, ref)
    assert np.abs(ours.numpy() - f["color"]).max() > 0.1


def _ssss_execs(temporal: bool):
    """(torch execute, JAX execute) of SSSSPass at H x W."""
    from arkoserenderer_torch.rendering.passes.ssss import SSSSPass as TSSSS
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TCfg
    from arkoserenderer_torch.rendering.registry import Registry as TReg
    from arkoserenderer_tpu.rendering.passes.ssss import SSSSPass as JSSSS
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JCfg
    from arkoserenderer_tpu.rendering.registry import Registry as JReg

    execs = []
    for Pass, Cfg, Reg, f32 in ((TSSSS, TCfg, TReg, torch.float32),
                                (JSSSS, JCfg, JReg, jnp.float32)):
        reg = Reg()
        for name, shape in (("SceneColor", (H, W, 3)), ("SceneMaterial", (H, W, 4)),
                            ("SceneDepth", (H, W))):
            reg.create(name, shape, f32)
        cfg = Cfg(width=W, height=H)
        if Pass is TSSSS:
            execs.append(Pass(temporal=temporal).construct(cfg, reg, torch.device("cpu")))
        else:
            execs.append(Pass(temporal=temporal).construct(cfg, reg))
    return execs


@pytest.fixture(scope="module")
def ssss_inputs(frame):
    from arkoserenderer_torch.rendering.pipeline import FrameContext as TCtx
    from arkoserenderer_tpu.assets.procedural import build_test_scene
    from arkoserenderer_tpu.rendering.pipeline import FrameContext as JCtx
    from arkoserenderer_torch import bridge

    _, cam = build_test_scene(viewport=(W, H))
    cs = cam.state(0)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    sss = (((xs - W / 2) ** 2 + (ys - H / 2) ** 2) < (H / 3) ** 2).astype(np.float32)
    mat = np.zeros((H, W, 4), np.float32)
    mat[..., 3] = sss
    state = {"SceneColor": frame["color"], "SceneMaterial": mat,
             "SceneDepth": frame["depth"] * 20.0}  # ~5 px radii at these depths

    def ctxs(i):
        t = TCtx(scene=None, camera=bridge.camera_state_from_numpy(cs._asdict(), "cpu"),
                 frame_index=i, delta_time=1 / 60)
        j = JCtx(scene=None, camera=cs, frame_index=jnp.asarray(i, jnp.int32),
                 delta_time=jnp.asarray(1 / 60, jnp.float32), row_offset=jnp.zeros((), jnp.int32))
        return t, j

    return state, sss, ctxs


@pytest.mark.parametrize("frame_index", FRAMES)
def test_temporal_ssss_matches_jax(ssss_inputs, frame_index):
    state, sss, ctxs = ssss_inputs
    t_exec, j_exec = _ssss_execs(temporal=True)
    t_ctx, j_ctx = ctxs(frame_index)
    ours = t_exec({k: T(v) for k, v in state.items()}, t_ctx)["SceneColor"]
    ref = j_exec({k: J(v) for k, v in state.items()}, j_ctx)["SceneColor"]
    held_with_flips(ours, ref)
    o = ours.numpy()
    np.testing.assert_array_equal(o[sss == 0], state["SceneColor"][sss == 0])
    assert np.abs(o - state["SceneColor"]).max() > 0.1  # the disc was blurred
    dense = _ssss_execs(temporal=False)[0]({k: T(v) for k, v in state.items()}, t_ctx)
    assert np.abs(o - dense["SceneColor"].numpy()).max() > 1e-3  # four taps, not sixteen
