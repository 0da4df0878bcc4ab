"""Soft RT shadows in the port against the JAX package's: each function of
``ops/shadow_denoise`` on seeded inputs, the soft branches of RTShadow and
RTLocalShadow pass by pass over three frames of a moving camera at 64^2
(a soft sun, a soft and a hard spot, a soft point light), and port twins
of tests/test_soft_shadows.py's penumbra tests (the denoised spot plane
has a penumbra while a zero-radius light stays binary; the path tracer's
soft sun moves real pixels at about the same energy).

Tolerances: the denoiser's functions 1e-5, absolute on values in [0, 1]
and relative above 1 (the sample counts, up to 24): XLA:CPU reassociates
(both packages fetch sub-pixel history with nine weighted shifts and
faster motion with a gather: tests/test_torch_history_branches.py holds
the branch itself). In the pass walk, the raw
masks are hard thresholds whose ray can flip on an ulp of its origin, so
as in test_torch_rt.py at most 0.1 % of values may differ; the denoised
planes and their moments mix a flip into their 5x5 neighbourhood, so at
most 2 % of their values may differ by more than 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.ops import shadow_denoise as tsd
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.ops import shadow_denoise as jsd
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

torch.set_num_threads(2)

DN_ATOL = 1e-5
RES = 64
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
SOFT_PASSES = ["Scene", "Geometry", "RTShadow", "RTLocalShadow"]
MASK_FLIP_SHARE = 0.001
DENOISED_SHARE = 0.02


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ours, ref, atol=DN_ATOL, name=""):
    """|ours - ref| <= atol * max(1, |ref|): atol on the [0, 1] planes,
    relative on the sample counts and positions above 1."""
    o, r = _n(ours), _n(ref)
    assert o.shape == r.shape, name
    err = np.abs(o - r) / np.maximum(1.0, np.abs(r))
    assert err.max() <= atol, (name, float(err.max()))


@pytest.fixture(scope="module")
def dn_inputs():
    """Seeded denoiser inputs at 24x20 with 2 planes: a depth ramp with a
    step, world positions from it, noisy 0/1 masks, history and moments."""
    rng = np.random.default_rng(21)
    h, w, c = 20, 24, 2
    depth = (0.3 + 0.02 * np.arange(w)[None, :] + 0.01 * np.arange(h)[:, None]).astype(np.float32)
    depth[:, w // 2:] += 0.05
    world = np.stack([np.tile(np.arange(w, dtype=np.float32), (h, 1)) * 0.1,
                      1.0 / depth, np.tile(np.arange(h, dtype=np.float32)[:, None], (1, w)) * 0.1],
                     -1).astype(np.float32)
    noisy = (rng.random((h, w, c)) < 0.5).astype(np.float32)
    hist = rng.random((h, w, c)).astype(np.float32)
    m1 = rng.random((h, w, c)).astype(np.float32)
    mom = np.concatenate([m1, m1 * m1 + 0.05 * rng.random((h, w, c)).astype(np.float32),
                          rng.integers(0, 24, (h, w, 1)).astype(np.float32)], -1)
    prev_depth = depth + rng.normal(0, 1e-3, depth.shape).astype(np.float32)
    xs = np.arange(w, dtype=np.float32) + 0.5
    ys = np.arange(h, dtype=np.float32) + 0.5
    px, py = (g.ravel() for g in np.meshgrid(xs, ys))
    slow = rng.uniform(-0.9, 0.9, (h, w, 2)).astype(np.float32)  # under a pixel
    fast = rng.uniform(-3.0, 3.0, (h, w, 2)).astype(np.float32)  # the gather branch
    normal = np.asarray(jsd.normals_from_depth(jnp.asarray(world)))
    pvp = np.array([[1.2, 0.0, 0.1, 0.0], [0.0, 1.5, 0.2, 0.0], [0.0, 0.0, 0.0, 0.1],
                    [0.05, 0.0, -1.0, 2.0]], np.float32)
    return dict(depth=depth, world=world, noisy=noisy, hist=hist, mom=mom,
                prev_depth=prev_depth, px=px, py=py, slow=slow, fast=fast, normal=normal,
                pvp=pvp, h=h, w=w, c=c)


DENOISE_CASES = ["initial_moments", "normals_from_depth", "camera_velocity", "reproject slow",
                 "reproject fast", "prefilter", "resolve_temporal first", "resolve_temporal",
                 "denoise first", "denoise"]


@pytest.mark.parametrize("case", DENOISE_CASES)
def test_shadow_denoise_matches_jax(dn_inputs, case):
    d = dn_inputs
    if case == "initial_moments":
        ours = tsd.initial_moments(d["h"], d["w"], d["c"], device="cpu")
        ref = jsd.initial_moments(d["h"], d["w"], d["c"])
        assert ours.shape == ref.shape and not ours.any()
    elif case == "normals_from_depth":
        _close(tsd.normals_from_depth(_t(d["world"])), d["normal"])
    elif case == "camera_velocity":
        _close(tsd.camera_velocity(_t(d["world"]), _t(d["px"]), _t(d["py"]), _t(d["pvp"]),
                                   d["w"], d["h"]),
               jsd.camera_velocity(jnp.asarray(d["world"]), d["px"], d["py"],
                                   jnp.asarray(d["pvp"]), d["w"], d["h"]), atol=1e-4)
    elif case.startswith("reproject"):
        vel = d["slow" if case.endswith("slow") else "fast"]
        args = (d["hist"], d["mom"], d["prev_depth"], d["depth"], vel)
        ours = tsd.reproject(*map(_t, args), _t(d["px"]), _t(d["py"]))
        ref = jsd.reproject(*map(jnp.asarray, args), d["px"], d["py"])
        for o, r, name in zip(ours, ref, ("hist", "moments", "confidence")):
            _close(o, r, name=name)
    elif case == "prefilter":
        _close(tsd.prefilter(_t(d["noisy"]), _t(d["normal"]), _t(d["depth"]), _t(d["mom"])),
               jsd.prefilter(*map(jnp.asarray, (d["noisy"], d["normal"], d["depth"], d["mom"]))))
    elif case.startswith("resolve_temporal"):
        first = case.endswith("first")
        conf = (np.arange(d["h"] * d["w"]).reshape(d["h"], d["w"]) % 5 != 0).astype(np.float32)
        filt = np.clip(d["noisy"] * 0.8 + 0.1, 0, 1).astype(np.float32)
        args = (filt, d["noisy"], d["hist"], d["mom"], conf)
        ours = tsd.resolve_temporal(*map(_t, args), first)
        ref = jsd.resolve_temporal(*map(jnp.asarray, args), first)
        for o, r, name in zip(ours, ref, ("resolved", "moments")):
            _close(o, r, name=name)
    else:
        first = case.endswith("first")
        args = (d["noisy"], d["depth"], d["normal"], d["slow"], d["hist"], d["mom"],
                d["prev_depth"])
        ours = tsd.denoise(*map(_t, args), _t(d["px"]), _t(d["py"]), first)
        ref = jsd.denoise(*map(jnp.asarray, args), d["px"], d["py"], first)
        for o, r, name in zip(ours, ref, ("resolved", "moments")):
            _close(o, r, name=name)


def soft_scene(mod_procedural, mod_lights, res: int = RES):
    """The test scene with one sphere, a soft sun (10 degrees, the radius
    of test_soft_shadows.py's penumbra test), a soft spot (source radius
    0.35, as there), a hard spot and a soft point light."""
    scene, cam = mod_procedural.build_test_scene(viewport=(res, res), n_spheres=1)
    scene.sun.angular_radius_deg = 10.0
    scene.spots.append(mod_lights.SpotLight(
        position=np.array([-2.0, 3.5, 0.0], np.float32),
        direction=np.array([0.0, -1.0, 0.0], np.float32), luminous_intensity_cd=60000.0,
        outer_cone_angle=np.radians(50.0), inner_cone_angle=np.radians(35.0),
        cast_shadows=True, source_radius=0.35))
    scene.spots.append(mod_lights.SpotLight(
        position=np.array([0.5, 3.0, 1.0], np.float32),
        direction=np.array([-0.2, -1.0, -0.1], np.float32), luminous_intensity_cd=150000.0,
        cast_shadows=True))
    scene.points.append(mod_lights.PointLight(
        position=np.array([1.5, 2.0, 1.5], np.float32), luminous_intensity_cd=20000.0,
        cast_shadows=True, source_radius=0.2))
    return scene, cam


@pytest.fixture(scope="module")
def soft_walk():
    """Both pipelines' shadow passes, pass by pass over three frames (the
    camera moved between them), each torch pass fed the JAX state:
    {(frame, pass): (torch, jax) updates}."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_torch.scene.lights as tlights
    import arkoserenderer_tpu.assets.procedural as jproc
    import arkoserenderer_tpu.scene.lights as jlights

    jscene, jcam = soft_scene(jproc, jlights)
    tscene, _ = soft_scene(tproc, tlights)
    sizes = dict(width=RES, height=RES, shadow_map_size=128, local_shadow_map_size=128)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    jpipe = j_make_pipeline(jcfg, rt_shadows=True, taa=False, bloom=False)
    tpipe = t_make_pipeline(tcfg, device="cpu", rt_shadows=True, taa=False, bloom=False)
    names = [n for n, _ in jpipe._executes]
    assert names == [n for n, _ in tpipe._executes] and names[:4] == SOFT_PASSES
    persistent = sorted(jpipe.registry.persistent_names)
    assert persistent == sorted(tpipe.registry.persistent_names)
    assert {"RTShadow.history", "RTShadow.moments", "RTShadow.depth", "RTLocalShadow.history",
            "RTLocalShadow.moments", "RTLocalShadow.depth"} <= set(persistent)

    jsa = jscene.build(with_bvh=True)
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes[:4]]
    state = jpipe.initial_state()
    out = {}
    for frame in range(3):
        if frame:
            jcam.post_render()
            jcam.position = jcam.position + np.array([0.25, 0.05, 0.0], np.float32)
            state = {k: state[k] for k in persistent}
        state["scene.version"] = jnp.asarray(0, jnp.int32)
        jcs = jcam.state(frame)
        tctx = TFrameContext(scene=tsa, camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                             frame_index=frame, delta_time=1 / 60)
        jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(frame, jnp.int32),
                             delta_time=jnp.asarray(1 / 60, jnp.float32),
                             row_offset=jnp.zeros((), jnp.int32))
        for (name, _), jexec, (_, texec) in zip(jpipe._executes, jitted, tpipe._executes):
            tupd = texec(bridge.frame_state_from_numpy(state, "cpu"), tctx)
            jupd = jexec(state, jctx)
            out[frame, name] = (tupd, jupd)
            state = {**state, **jupd}
    return out


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("pass_name", ["RTShadow", "RTLocalShadow"])
def test_soft_pass_matches_jax(soft_walk, pass_name, frame):
    tupd, jupd = soft_walk[frame, pass_name]
    assert set(tupd) == set(jupd)
    for key in sorted(jupd):
        o, r = _n(tupd[key]), _n(jupd[key])
        assert o.shape == r.shape, key
        if key.endswith(".depth"):
            np.testing.assert_allclose(o, r, atol=1e-6, rtol=0, err_msg=key)
        else:
            assert (np.abs(o - r) > 1e-4).mean() <= DENOISED_SHARE, (key, np.abs(o - r).max())
    if pass_name == "RTLocalShadow":
        # The hard spot's plane is a raw mask: equal but for flips.
        o, r = _n(tupd["ShadowMask.locals"][1]), _n(jupd["ShadowMask.locals"][1])
        assert (o != r).mean() <= MASK_FLIP_SHARE


def test_soft_walk_has_penumbrae(soft_walk):
    """Frame 2's denoised sun and soft spot planes hold values strictly
    between lit and shadowed; the hard spot's plane is binary."""
    sun = _n(soft_walk[2, "RTShadow"][0]["ShadowMask.sun"])
    locals_ = _n(soft_walk[2, "RTLocalShadow"][0]["ShadowMask.locals"])
    for plane in (sun, locals_[0]):
        assert ((plane > 0.15) & (plane < 0.85)).sum() > 10
    assert ((locals_[1] == 0.0) | (locals_[1] == 1.0)).all()
    count = _n(soft_walk[2, "RTShadow"][0]["RTShadow.moments"])[..., 2]
    assert count.max() == 3.0


def test_soft_spot_shadow_penumbra():
    """Port twin of test_soft_shadows.py::test_soft_spot_shadow_penumbra at
    96^2: after 12 frames the soft spot's plane has a penumbra band, and
    the same spot with no radius stays binary."""
    import arkoserenderer_torch.assets.procedural as tproc
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.scene.lights import SpotLight

    cfg = TPipelineConfig(width=96, height=96, shadow_map_size=128,
                          raster=TRasterConfig(**RASTER))

    def render(radius, frames):
        scene, cam = tproc.build_test_scene(viewport=(96, 96), n_spheres=1)
        scene.sun.illuminance_lux = 2000.0
        scene.spots.append(SpotLight(
            position=np.array([-2.0, 3.5, 0.0], np.float32),
            direction=np.array([0.0, -1.0, 0.0], np.float32), luminous_intensity_cd=60000.0,
            outer_cone_angle=np.radians(50.0), inner_cone_angle=np.radians(35.0),
            cast_shadows=True, source_radius=radius))
        r = Renderer(scene, cam, cfg, device="cpu", rt_shadows=True, taa=False, bloom=False)
        img = r.render_frames(frames)
        return img.numpy(), r.state["ShadowMask.locals"][0].numpy()

    img, plane = render(0.35, 12)
    assert np.isfinite(img).all() and np.isfinite(plane).all()
    assert (plane >= 0).all() and (plane <= 1).all()
    assert ((plane > 0.15) & (plane < 0.85)).sum() > 20
    _, hard = render(0.0, 1)
    assert ((hard < 0.05) | (hard > 0.95)).all()


def test_pathtracer_soft_sun_penumbra():
    """Port twin of test_soft_shadows.py::test_pathtracer_soft_sun_penumbra
    at 48^2: a 14 degree sun moves real pixels against the hard sun, at
    about the same energy."""
    import arkoserenderer_torch.assets.procedural as tproc
    from arkoserenderer_torch.models.pathtracer import PathTracer

    def render(deg, spp):
        scene, cam = tproc.build_test_scene(viewport=(48, 48), n_spheres=1)
        scene.sun.angular_radius_deg = deg
        scene.env_map = np.zeros((1, 2, 3), np.float32)
        scene.env_brightness = 0.0
        scene.ambient_lx = 0.0
        pt = PathTracer(scene, cam, 48, 48, max_bounces=1, aa=False, device="cpu")
        pt.render_sample(spp)
        return pt.radiance().numpy()

    hard = render(0.0, 1)
    soft = render(14.0, 24)
    assert np.isfinite(soft).all()
    lum_h, lum_s = hard.mean(-1), soft.mean(-1)
    assert abs(lum_s.mean() - lum_h.mean()) / max(lum_h.mean(), 1e-6) < 0.12
    assert (np.abs(lum_s - lum_h) > 0.02 * max(lum_h.max(), 1e-6)).sum() > 10
