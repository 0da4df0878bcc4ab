"""The port's post-chain functions (ops/ssao.py, ops/postprocess.py, the PCF
of ops/shadow.py) against the JAX package's, function against function, on
synthetic inputs made from a numpy seed: a 64x96 frame looking at a bumpy
height field from a perspective camera.

Tolerances (f32 on both sides; XLA:CPU fuses some multiply-adds and has its
own exp/sqrt/acos approximations, eager torch rounds every operation):
  * smooth functions (fog, CoC, motion blur, depth of field, CAS, world
    position): rtol 1e-5 plus an atol a few ulps of the values' scale;
  * functions with a hard threshold (PCF's depth compare, FXAA's edge test,
    SSAO's occlusion test) flip whole taps on an ulp: they are held by the
    share of pixels that differ at all plus a max-abs bound on the rest,
    each stated in its test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.core import halton as thalton
from arkoserenderer_torch.core import mathx as tmx
from arkoserenderer_torch.ops import envmap as tenv
from arkoserenderer_torch.ops import postprocess as tpp
from arkoserenderer_torch.ops import shadow as tshadow
from arkoserenderer_torch.ops import ssao as tssao
from arkoserenderer_tpu.core import halton as jhalton
from arkoserenderer_tpu.ops import envmap as jenv
from arkoserenderer_tpu.ops import postprocess as jpp
from arkoserenderer_tpu.ops import shadow as jshadow
from arkoserenderer_tpu.ops import ssao as jssao

H, W = 64, 96
NEAR = 0.25


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def close(ours, ref, atol, rtol=1e-5):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def frame():
    """A synthetic G-buffer: view distance z(x, y) in 3..9 m with a step
    edge, reverse-Z depth near / z, a sky band with depth 0 on top, unit
    normals tilted around +view, HDR colour and a velocity field."""
    rng = np.random.default_rng(42)
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    z = 5.0 + 1.5 * np.sin(xs / 9.0) + 1.0 * np.cos(ys / 7.0) + 1.5 * (xs > W * 0.6)
    valid = ys > 6.0
    depth = np.where(valid, NEAR / z, 0.0).astype(np.float32)
    view = tmx.look_at((0.0, 1.5, 4.0), (0.0, 0.5, 0.0))
    proj = tmx.perspective_reverse_z(np.radians(60.0), W / H, NEAR, None)
    vp = (proj @ view).astype(np.float32)
    cam_pos = np.array([0.0, 1.5, 4.0], np.float32)
    to_cam = -view[2, :3]  # the camera looks down -Z of view space
    nrm = -to_cam[None, None, :] + 0.6 * rng.normal(size=(H, W, 3))
    nrm[: H // 3] = [0.0, 1.0, 0.0]  # a region of exactly vertical normals
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    color = rng.lognormal(-1.0, 1.0, size=(H, W, 3)).astype(np.float32)
    vel = (rng.normal(size=(H, W, 2)) * 0.3 + np.array([3.0, -1.5])).astype(np.float32)
    vel[:, : W // 4] = 0.0  # still tiles: equal speeds, the first index wins
    vel[H // 2:, W // 2:] *= 3.0
    vel[40, 70] = [90.0, -40.0]  # one pixel beyond max_blur_px (more would tie at the clamp)
    return dict(depth=depth, valid=valid, vp=vp, cam_pos=cam_pos, nrm=nrm, color=color,
                vel=vel, px=xs.ravel().astype(np.float32), py=ys.ravel().astype(np.float32))


def test_host_tables_equal_jax():
    for n in (4, 8, 24):
        np.testing.assert_array_equal(thalton.fibonacci_disc(n), jhalton.fibonacci_disc(n))
    np.testing.assert_array_equal(tssao.make_ssao_kernel(16), jssao.make_ssao_kernel(16))


def test_average_radiance_matches_jax():
    from arkoserenderer_tpu.assets.procedural import gradient_env_map

    env = gradient_env_map(32)
    close(tenv.average_radiance(T(env)), jenv.average_radiance(J(env)), atol=1e-6)


def test_reconstruct_world_pos_matches_jax(frame):
    """atol 2e-4 m on positions up to ~10 m from a depth of ~0.03: the
    inverse view-projection comes from two LU routines, and the homogeneous
    divide amplifies its last bits."""
    f = frame
    inv = np.linalg.inv(f["vp"].astype(np.float64)).astype(np.float32)
    ours = tssao.reconstruct_world_pos(T(f["depth"].ravel()), T(f["px"]), T(f["py"]), T(inv), W, H)
    ref = jssao.reconstruct_world_pos(J(f["depth"].ravel()), J(f["px"]), J(f["py"]), J(inv), W, H)
    close(ours, ref, atol=2e-4)
    assert (ours[: W * 6] == 0).all()  # the sky rows: guarded to 0
    np.testing.assert_allclose(tssao.inverse4(T(f["vp"])).numpy(), inv, rtol=1e-4, atol=1e-5)


def test_ssao_matches_jax(frame):
    """SSAO is compared after the pass's 3x3 blur, by its mean (within
    0.01) and by the share of pixels off by more than 0.1 (under 2 %), not
    by a colour bound. Its kernel rotation is
    fract((px * 12.9898 + py * 78.233) * 43758.5453) at magnitudes of ~1e8,
    where one f32 ulp is 8 or more: whether a backend fuses the multiply-add
    decides the angle entirely, so two correct backends may rotate every
    pixel's kernel differently. With the rotation of the reference fed to
    the port (the pass computes it once, at construct), the occlusion test
    ``scene_z < sample_z - bias`` still flips on an ulp: there the two are
    held to under 1 % of pixels differing by more than 1e-4."""
    from arkoserenderer_torch.ops.image import blur3 as t_blur3
    from arkoserenderer_tpu.ops.image import blur3 as j_blur3

    f = frame
    kernel = tssao.make_ssao_kernel(16)
    args = (f["depth"], f["nrm"].reshape(-1, 3), f["valid"].ravel(), f["px"], f["py"], f["vp"],
            np.float32(NEAR))
    ref = jssao.ssao(*(J(a) for a in args), W, H, kernel)
    ours = tssao.ssao(*(T(a) for a in args[:6]), torch.tensor(NEAR), W, H, kernel)
    assert ours.shape == (H * W,) and float(ours.min()) >= 0.0 and float(ours.max()) <= 1.0
    assert float(ours.min()) < 0.9  # the step edge occludes something
    assert (ours[: W * 6] == 1.0).all()  # sky: unoccluded
    ob = t_blur3(ours.reshape(H, W, 1)).numpy()[..., 0]
    rb = np.asarray(j_blur3(ref.reshape(H, W, 1)))[..., 0]
    assert abs(ob.mean() - rb.mean()) < 0.01
    assert (np.abs(ob - rb) > 0.1).mean() < 0.02

    angle = (J(f["px"]) * 12.9898 + J(f["py"]) * 78.233) * 43758.5453
    angle = (angle - jnp.floor(angle)) * (2.0 * jnp.pi)
    rot = (T(np.asarray(jnp.cos(angle))), T(np.asarray(jnp.sin(angle))))
    fed = tssao.ssao(*(T(a) for a in args[:6]), torch.tensor(NEAR), W, H, kernel, rotation=rot)
    off = np.abs(fed.numpy() - np.asarray(ref)) > 1e-4
    assert off.mean() < 0.01


def test_apply_fog_matches_jax(frame):
    f = frame
    rng = np.random.default_rng(5)
    world = (rng.normal(size=(H, W, 3)) * 6.0).astype(np.float32)
    fog = np.array([0.6, 0.7, 0.9], np.float32)
    ours = tpp.apply_fog(T(f["color"]), T(world), T(f["valid"]), T(f["cam_pos"]), T(fog),
                         density=0.02, height_falloff=0.05)
    ref = jpp.apply_fog(J(f["color"]), J(world), J(f["valid"]), J(f["cam_pos"]), J(fog),
                        density=0.02, height_falloff=0.05)
    close(ours, ref, atol=1e-6)


@pytest.mark.parametrize("tile", [8, 16])
def test_motion_blur_matches_jax(frame, tile):
    """atol 2e-5 on colours of order 1 (up to ~20): 8 bilinear taps summed
    and divided."""
    f = frame
    ours = tpp.motion_blur(T(f["color"]), T(f["vel"]), T(f["depth"]), tile=tile)
    ref = jpp.motion_blur(J(f["color"]), J(f["vel"]), J(f["depth"]), tile=tile)
    close(ours, ref, atol=2e-5)
    assert np.abs(ours.numpy() - f["color"]).max() > 0.1  # it did blur


def test_compute_coc_matches_jax(frame):
    f = frame
    args = (np.float32(NEAR), np.float32(5.0), np.float32(40.0))
    ours = tpp.compute_coc(T(f["depth"]), T(f["valid"]), *(torch.tensor(float(a)) for a in args))
    ref = jpp.compute_coc(J(f["depth"]), J(f["valid"]), *(J(a) for a in args))
    close(ours, ref, atol=1e-5)  # pixels, up to 16
    assert float(ours.min()) < -1.0 and float(ours.max()) == 16.0


def test_depth_of_field_matches_jax(frame):
    """atol 2e-5: 24 bilinear taps summed and divided, colours up to ~20."""
    f = frame
    coc = np.asarray(jpp.compute_coc(J(f["depth"]), J(f["valid"]), J(np.float32(NEAR)),
                                     J(np.float32(5.0)), J(np.float32(40.0))))
    ours = tpp.depth_of_field(T(f["color"]), T(coc), num_taps=24)
    ref = jpp.depth_of_field(J(f["color"]), J(coc), num_taps=24)
    close(ours, ref, atol=2e-5)
    assert np.abs(ours.numpy() - f["color"]).max() > 0.1


def ldr_image(seed):
    """A display-range image with flat areas, soft gradients and hard edges."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    img = np.stack([xs, ys, 0.5 + 0.5 * np.sin(9 * xs + 5 * ys)], -1)
    img[H // 4: H // 2, W // 4: W // 2] = [0.9, 0.1, 0.2]
    img += rng.normal(size=img.shape) * 0.01
    return np.clip(img, 0, 1).astype(np.float32)


def test_fxaa_matches_jax():
    """FXAA's edge test and direction test flip on an ulp of luma: under
    0.5 % of pixels may differ by more than 1e-6, and none by more than a
    3-tap blend can move a pixel (0.5)."""
    img = ldr_image(6)
    ours = tpp.fxaa(T(img)).numpy()
    ref = np.asarray(jpp.fxaa(J(img)))
    diff = np.abs(ours - ref).max(-1)
    assert (diff > 1e-6).mean() < 0.005
    assert diff.max() <= 0.5
    assert (np.abs(ours - img).max(-1) > 1e-3).mean() > 0.01  # edges were blended


def test_cas_matches_jax():
    img = ldr_image(7)
    ours = tpp.cas(T(img), 0.5)
    close(ours, jpp.cas(J(img), 0.5), atol=2e-6)
    assert np.abs(ours.numpy() - img).max() > 1e-3


def test_sample_shadow_pcf_matches_jax():
    """PCF's ``depth + bias >= occ`` flips a whole tap (1/8) on an ulp:
    under 0.5 % of receivers may differ at all, by at most two taps."""
    rng = np.random.default_rng(8)
    s = 64
    ys, xs = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    view = tmx.look_at((1.5, 3.0, 1.0), (1.2, 0.0, 0.8))
    vp = (tmx.perspective_reverse_z(np.radians(63.0), 1.0, 0.05, far=40.0) @ view)
    vp = vp.astype(np.float32)
    # The map: a floor at y = 0 seen from the light, with a raised block.
    occ_h = np.where((xs > 20) & (xs < 40) & (ys > 24) & (ys < 44), 1.0, 0.0)
    dist = (3.0 - occ_h) / 0.97
    smap = ((40.0 * 0.05 / (40.0 - 0.05)) / dist + 0.05 / (40.0 - 0.05) * -1.0 + 0.0)
    smap = smap.astype(np.float32)
    world = np.stack([rng.uniform(-1.5, 4.0, 5000), rng.uniform(0.0, 1.2, 5000),
                      rng.uniform(-2.0, 3.5, 5000)], -1).astype(np.float32)
    ndl = rng.uniform(0.0, 1.0, 5000).astype(np.float32)
    ours = tshadow.sample_shadow_pcf(T(smap), T(vp), T(world), T(ndl)).numpy()
    ref = np.asarray(jshadow.sample_shadow_pcf(J(smap), J(vp), J(world), J(ndl)))
    diff = np.abs(ours - ref)
    assert (diff > 0).mean() < 0.005 and diff.max() <= 0.25 + 1e-6
    partial = (ours > 0) & (ours < 1)
    assert partial.any() and (ours == 0).any() and (ours == 1).any()  # all three regimes
