"""The port's translucency slice against the JAX package's: the per-field
shading front end (``ops/interpolate``, ``ops/texture``'s gradient
sampler), ``ops/shading.shade_visibility_buffer``, the depth peel of the
raster, the two behaviour tests of tests/test_translucent.py on the port,
and translucent triangles left out of the shadow maps.
(test_torch_translucent_frames.py holds the pass and the whole frames.)

Inputs are built by the JAX package and carried over by the bridge (the
scene arrays, the camera, the raster setup and the visibility buffer), so
both sides shade the same pixels; the frames are built by each package
from its own scene code.

Tolerances:
  * barycentrics, interpolated attributes, LODs and texture samples:
    rtol/atol 1e-5 (XLA:CPU fuses multiply-adds; eager torch rounds each);
  * the G-buffer: test_torch_passes.py's per-resource bounds (COLOR_ATOL),
    valid and depth equal; the spot's IES index and PCF taps are hard
    thresholds, held as test_torch_passes.py holds the spot frame (FLIPS);
  * the peel raster: ids equal, depths within 16 ulps (8 at most seen),
    each side peeling below its own layer. XLA:CPU fuses the edge
    functions' and the depth sum's multiply-adds: on the front pane's first
    layer 79 of 226 covered depths differ (pixel (35, 1): JAX 0x3d2da633,
    the port 0x3d2da632). Unfused float32 arithmetic in numpy gives the port's depth
    on all 226 and JAX's on 147; fusing those multiply-adds gives JAX's on
    203. Bit equality is held on the card, kernel against plain raster.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.ops import interpolate as tip
from arkoserenderer_torch.ops import raster as traster
from arkoserenderer_torch.ops import shading as tshading
from arkoserenderer_torch.ops import texture as ttx
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.ops import interpolate as jip
from arkoserenderer_tpu.ops import raster as jraster
from arkoserenderer_tpu.ops import shading as jshading
from arkoserenderer_tpu.ops import texture as jtx
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_passes import COLOR_ATOL, RASTER, RES, _np, compare_flips

torch.set_num_threads(2)

SIZES = dict(width=RES, height=RES, shadow_map_size=128, local_shadow_map_size=64)


def _pkg(name):
    """The modules a scene builder needs, of one package."""
    import importlib

    root = {"jax": "arkoserenderer_tpu", "torch": "arkoserenderer_torch"}[name]
    proc = importlib.import_module(f"{root}.assets.procedural")
    sc = importlib.import_module(f"{root}.scene.scene")
    lights = importlib.import_module(f"{root}.scene.lights")
    return proc, sc, lights


def glass_panes(pkg, with_back: bool):
    """tests/test_translucent.py's ``scene_with_glass_panes``: the JAX
    package's from that file, the port's through
    ``procedural.add_glass_panes``."""
    if pkg == "jax":
        from test_translucent import scene_with_glass_panes

        return scene_with_glass_panes(with_back)
    from arkoserenderer_torch.assets.procedural import add_glass_panes, build_test_scene

    scene, cam = build_test_scene(viewport=(RES, RES), n_spheres=1)
    add_glass_panes(scene, with_back)
    return scene, cam


def glass(pkg, alpha: float):
    """tests/test_translucent.py's ``scene_with_glass`` (one pane of
    ``alpha``; None: no pane) with either package's modules."""
    proc, sc, _ = _pkg(pkg)
    scene, cam = proc.build_test_scene(viewport=(RES, RES), n_spheres=1)
    if alpha is None:
        return scene, cam
    mat = scene.add_material(sc.Material(
        base_color_factor=np.array([0.4, 0.6, 0.9, alpha], np.float32),
        roughness_factor=0.1, blend_mode=sc.BLEND_TRANSLUCENT))
    box = proc.make_box((1.6, 1.6, 0.1))
    box.material = mat
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (-2.0, 1.0, 1.6)
    scene.add_instance(scene.add_segment(box), w)
    return scene, cam


def textured_scene():
    """The JAX test scene with every texture slot in use: a double-sided
    box whose material samples base, normal, metallic-roughness, emissive
    and occlusion textures (seeded noise, one of them 16x64), a shadow-casting spot with an IES profile and a point light."""
    from arkoserenderer_tpu.assets.procedural import build_test_scene, make_box
    from arkoserenderer_tpu.scene.lights import PointLight, SpotLight
    from arkoserenderer_tpu.scene.scene import Material

    rng = np.random.default_rng(12)
    scene, cam = build_test_scene(viewport=(RES, RES), n_spheres=2)

    def tex(h, w, srgb):
        return scene.add_texture(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), srgb=srgb)

    mat = scene.add_material(Material(
        base_color_factor=np.array([0.9, 0.8, 0.7, 1.0], np.float32),
        emissive_factor=np.array([0.3, 0.2, 0.1], np.float32),
        metallic_factor=0.6, roughness_factor=0.7,
        base_color_tex=tex(32, 32, True), normal_tex=tex(16, 16, False),
        mr_tex=tex(16, 64, False), emissive_tex=tex(16, 16, True),
        occlusion_tex=tex(8, 8, False), double_sided=True))
    box = make_box((1.2, 1.2, 1.2))
    box.material = mat
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.5, 0.8, 1.2)
    scene.add_instance(scene.add_segment(box), w)
    ies = np.clip(np.cos(np.linspace(0, np.pi, 256)) * 1.2, 0.05, 1.0).astype(np.float32)
    scene.spots.append(SpotLight(position=np.array([0.5, 3.0, 1.0], np.float32),
                                 direction=np.array([-0.2, -1.0, -0.1], np.float32),
                                 luminous_intensity_cd=150000.0, cast_shadows=True,
                                 ies_lut=ies))
    scene.points.append(PointLight(position=np.array([2.0, 1.5, 2.5], np.float32),
                                   luminous_intensity_cd=4000.0))
    return scene, cam


@pytest.fixture(scope="module")
def shading_inputs():
    """The textured scene's reference-mode frame walked in JAX up to
    VisibilityShading: (JAX scene arrays, camera state, the state that
    pass reads, the port's scene arrays and camera)."""
    from arkoserenderer_tpu.models.standard import make_forward_pipeline
    from arkoserenderer_tpu.rendering.pipeline import FrameContext

    scene, cam = textured_scene()
    st = scene.static_info()
    assert st.uses_emissive_tex and st.uses_occlusion_tex and st.n_spots == st.n_points == 1
    cfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=st, shading_mode="reference",
                          **SIZES)
    pipe = make_forward_pipeline(cfg, taa=False, bloom=False)
    sa, cs = scene.build(), cam.state(0)
    ctx = FrameContext(scene=sa, camera=cs, frame_index=jnp.asarray(0, jnp.int32),
                       delta_time=jnp.asarray(1 / 60, jnp.float32),
                       row_offset=jnp.zeros((), jnp.int32))
    state = pipe.initial_state()
    state["scene.version"] = jnp.asarray(0, jnp.int32)
    for name, execute in pipe._executes:
        if name == "VisibilityShading":
            break
        state = {**state, **jax.jit(execute)(state, ctx)}
    assert "ShadowMap.locals" in state
    return sa, cs, state, bridge.scene_arrays_from_numpy(sa._asdict(), "cpu"), \
        bridge.camera_state_from_numpy(cs._asdict(), "cpu")


def _pixels(n_res=RES):
    xs = np.arange(n_res, dtype=np.float32) + 0.5
    px, py = np.meshgrid(xs, xs)
    return px.ravel(), py.ravel()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _setup(state):
    return bridge.frame_state_from_numpy({"vis.setup": state["vis.setup"]}, "cpu")["vis.setup"]


def test_pixel_barycentrics_and_interpolation_match_jax(shading_inputs):
    """Every pixel of the frame, covered or not (VIS_NONE reads setup row 0),
    against JAX's ``pixel_barycentrics`` and ``interpolate_with_grad``."""
    sa, _, state, tsa, _ = shading_inputs
    px, py = _pixels()
    vis = np.asarray(state["Visibility"]).reshape(-1)
    assert (vis == -1).any() and (vis >= 0).mean() > 0.3
    jg = jip.pixel_barycentrics(jnp.asarray(vis), state["vis.setup"], sa.indices,
                                jnp.asarray(px), jnp.asarray(py))
    tg = tip.pixel_barycentrics(_t(vis), _setup(state), tsa.indices, _t(px), _t(py))
    for f in ("tri", "valid", "corners"):
        np.testing.assert_array_equal(_np(getattr(tg, f)), np.asarray(getattr(jg, f)), err_msg=f)
    for f in ("bary", "bary_dx", "bary_dy"):
        np.testing.assert_allclose(_np(getattr(tg, f)), np.asarray(getattr(jg, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    valid = np.asarray(jg.valid)
    for attr in ("uvs", "positions"):
        vals = np.asarray(getattr(sa, attr))[np.asarray(jg.corners)]           # (N, 3, C)
        jv = jip.interpolate_with_grad(getattr(sa, attr), jg)
        tv = tip.interpolate_with_grad(getattr(tsa, attr), tg)
        jv = (jip.interpolate(getattr(sa, attr), jg), *jv)
        tv = (tip.interpolate(getattr(tsa, attr), tg), *tv)
        for k, (o, r) in enumerate(zip(tv, jv)):
            o, r = _np(o), np.asarray(r)
            np.testing.assert_allclose(o[valid], r[valid], rtol=1e-5, atol=1e-5, err_msg=attr)
            # Uncovered pixels weigh row 0's corners by barycentrics far out
            # of the triangle: held relative to the size of the sum before
            # it cancels, sum_k |b_k v_k| (the +1 px sums for the gradients).
            bary = np.asarray((jg.bary, jg.bary, jg.bary_dx, jg.bary_dy)[k])
            size = np.abs(bary[:, :, None] * vals).sum(1) + np.abs(
                np.asarray(jg.bary)[:, :, None] * vals).sum(1)
            assert (np.abs(o - r) <= 1e-5 * (1.0 + size))[~valid].all(), attr


def _gradient_case():
    """Seeded sampler inputs: every texture of the textured scene, uvs up to
    6 outside [0, 1] (both wrap modes: the pool's textures repeat; half
    the ids are remapped to a clamped copy below), gradients from
    magnification to minification past the last mip."""
    rng = np.random.default_rng(5)
    n = 4096
    uv = rng.uniform(-6.0, 7.0, (n, 2)).astype(np.float32)
    scale = (10.0 ** rng.uniform(-5, 0, (n, 1))).astype(np.float32)
    duv_dx = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    duv_dy = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    return uv, duv_dx, duv_dy


@pytest.mark.parametrize("quality", ["trilinear", "bilinear"])
def test_compute_lod_and_sample_grad_match_jax(shading_inputs, quality):
    sa, _, _, tsa, _ = shading_inputs
    uv, dx, dy = _gradient_case()
    n_tex = int(np.asarray(sa.textures.n_mips).astype(bool).sum())
    tex = (np.arange(uv.shape[0]) % n_tex).astype(np.int32)
    # Half the lanes read a clamped copy of the pool (the wrap flag per id).
    pools = {"repeat": (sa.textures, tsa.textures)}
    wrap = np.asarray(sa.textures.wrap).copy()
    wrap[:] = jtx.WRAP_CLAMP
    pools["clamp"] = (sa.textures._replace(wrap=jnp.asarray(wrap)),
                      tsa.textures._replace(wrap=_t(wrap)))
    for label, (jpool, tpool) in pools.items():
        lod_j = jtx.compute_lod(jpool, jnp.asarray(tex), jnp.asarray(dx), jnp.asarray(dy))
        lod_t = ttx.compute_lod(tpool, _t(tex), _t(dx), _t(dy))
        np.testing.assert_allclose(_np(lod_t), np.asarray(lod_j), rtol=1e-5, atol=1e-5)
        for srgb in (True, False):
            j = jtx.sample_grad(jpool, jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(dx),
                                jnp.asarray(dy), decode_srgb=srgb, quality=quality)
            t = ttx.sample_grad(tpool, _t(tex), _t(uv), _t(dx), _t(dy), decode_srgb=srgb,
                                quality=quality)
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{label} srgb={srgb}")


def test_sample_grad_qualities_by_name(shading_inputs):
    """"auto" and "stochastic" are trilinear (the reference's per-field path
    has no stochastic filter); "sorted" (ported since it raised here) is the
    reference's sorted tile gather, within 1e-6 of JAX's on the textured
    scene's pool (tests/test_torch_sorted_texture.py holds it further); an
    unknown name raises ValueError, as in the reference."""
    sa, _, _, tsa, _ = shading_inputs
    uv, dx, dy = (_t(a[:64]) for a in _gradient_case())
    tex = torch.full((64,), 4, dtype=torch.int32)
    tri = ttx.sample_grad(tsa.textures, tex, uv, dx, dy)
    for q in ("auto", "stochastic"):
        assert torch.equal(ttx.sample_grad(tsa.textures, tex, uv, dx, dy, quality=q), tri)
    # The tile gather takes whole tiles of 1,024 pixels, as a frame has them.
    uv, dx, dy = (_t(a[:1024]) for a in _gradient_case())
    tex = torch.full((1024,), 4, dtype=torch.int32)
    ours = ttx.sample_grad(tsa.textures, tex, uv, dx, dy, quality="sorted")
    ref = jax.jit(lambda *a: jtx.sample_grad(*a, quality="sorted"))(
        sa.textures, jnp.asarray(tex.numpy()), *(jnp.asarray(a.numpy()) for a in (uv, dx, dy)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    for q in ("aniso4", "stochastic1", "nearest"):
        with pytest.raises(ValueError):
            ttx.sample_grad(tsa.textures, tex, uv, dx, dy, quality=q)


# The G-buffer fields and the resources they fill, for test_torch_passes' bounds.
GB_FIELDS = {"color": "SceneColor", "normal": "SceneNormal", "velocity": "SceneVelocity",
             "base_color": "SceneBaseColor", "material": "SceneMaterial"}


@pytest.mark.parametrize("sun", ["pcf_map", "rt_mask"])
def test_shade_visibility_buffer_matches_jax(shading_inputs, sun):
    """Every GBuffer field of the textured frame: the sun by PCF taps of the
    sun map, or by a seeded ray-traced mask in [0, 1]; the spot through its
    IES profile and its shadow map; the point light."""
    sa, cs, state, tsa, tcs = shading_inputs
    px, py = _pixels()
    n = px.shape[0]
    mask = np.random.default_rng(3).uniform(0, 1, n).astype(np.float32)
    kw_j = dict(local_shadow_maps=state["ShadowMap.locals"], spot_shadow_flags=(True,),
                n_spots=1, n_points=1)
    kw_t = dict(local_shadow_maps=_t(state["ShadowMap.locals"]), spot_shadow_flags=(True,),
                n_spots=1, n_points=1)
    if sun == "pcf_map":
        kw_j.update(shadow_map=state["ShadowMap.sun"], sun_shadow_vp=sa.lights.sun_view_proj)
        kw_t.update(shadow_map=_t(state["ShadowMap.sun"]),
                    sun_shadow_vp=tsa.lights.sun_view_proj)
    else:
        kw_j.update(shadow_mask=jnp.asarray(mask))
        kw_t.update(shadow_mask=_t(mask))
    vis = np.asarray(state["Visibility"]).reshape(-1)
    depth = np.asarray(state["SceneDepth"]).reshape(-1)
    jgb = jshading.shade_visibility_buffer(
        sa, cs, jnp.asarray(vis), jnp.asarray(depth), state["vis.setup"], jnp.asarray(px),
        jnp.asarray(py), RES, RES, **kw_j)
    tgb = tshading.shade_visibility_buffer(
        tsa, tcs, _t(vis), _t(depth), _setup(state), _t(px), _t(py), RES, RES, **kw_t)
    np.testing.assert_array_equal(_np(tgb.valid), np.asarray(jgb.valid))
    np.testing.assert_array_equal(_np(tgb.depth), np.asarray(jgb.depth))
    assert (np.asarray(jgb.material)[:, 2] < 0.99).any()   # the occlusion texture is read
    assert np.abs(np.asarray(jgb.color)).max() > 0.1 and np.isfinite(_np(tgb.color)).all()
    for field, key in GB_FIELDS.items():
        o, r = _np(getattr(tgb, field)), np.asarray(getattr(jgb, field))
        if field == "color":
            # The spot's PCF compare and IES index are thresholds: the spot
            # frame's bound of test_torch_passes.py.
            compare_flips(key, o, r, COLOR_ATOL[key], 0.005, 2.0)
        else:
            np.testing.assert_allclose(o, r, atol=COLOR_ATOL[key], rtol=0, err_msg=key)


def _pane_raster(with_back: bool):
    """The translucent triangles of the two-pane scene, set up and binned by
    JAX as ForwardTranslucent forms them: (JAX setup, bins, port copies)."""
    from arkoserenderer_tpu.rendering.passes.geometry import transform_vertices_clip
    from arkoserenderer_tpu.scene.scene import BLEND_TRANSLUCENT

    scene, cam = glass_panes("jax", with_back)
    sa, cs = scene.build(), cam.state(0)
    mat = sa.inst_material[sa.tri_instance]
    tri = (sa.materials.blend_mode[mat] == BLEND_TRANSLUCENT) & sa.tri_valid
    clip = transform_vertices_clip(sa, cs.view_proj)
    setup = jraster.setup_triangles(clip, sa.indices, tri, RES, RES, cull_backfaces=False,
                                    w_eps=cs.near)
    cfg = JRasterConfig(**RASTER)
    bins = jraster.bin_triangles(setup, RES, RES, cfg)
    return (setup, bins, cfg, _setup({"vis.setup": setup}),
            traster.TileBins(*(_t(x) for x in bins)), TRasterConfig(**RASTER))


@pytest.mark.parametrize("with_back", [False, True], ids=["front", "both"])
def test_peel_raster_matches_jax(with_back):
    """Four peels of the panes, each below its own side's last layer, the
    plain raster against JAX's ``rasterize_tiles`` on the same setup and
    bins: ids equal, depths within 16 ulps (XLA:CPU's fused multiply-adds;
    see the module docstring)."""
    jsetup, jbins, jcfg, tsetup, tbins, tcfg = _pane_raster(with_back)
    jlim = tlim = None
    covered = []
    for _ in range(4):
        jv, jd = jraster.rasterize_tiles(jsetup, jbins, RES, RES, jcfg, depth_limit=jlim)
        tv, td = traster.rasterize_tiles_plain(tsetup, tbins, RES, RES, tcfg, depth_limit=tlim)
        jv, jd = np.asarray(jv), np.asarray(jd)
        np.testing.assert_array_max_ulp(td.numpy(), jd, maxulp=16)
        np.testing.assert_array_equal(tv.numpy(), jv)
        covered.append(int((jv >= 0).sum()))
        jlim, tlim = jnp.asarray(jd), td
    # A pane is a thin box: two faces over every pane pixel; the back pane
    # adds two more layers where it lies behind the front one.
    assert covered[0] > 200 and covered[1] > 0.9 * covered[0]
    assert (covered[2] > 100) == with_back


# -- the behaviour tests of tests/test_translucent.py, on the port ----------------


def _cfgs(**kw):
    return (JPipelineConfig(raster=JRasterConfig(**RASTER), shadow_map_size=128, width=RES,
                            height=RES, **kw),
            TPipelineConfig(raster=TRasterConfig(**RASTER), shadow_map_size=128, width=RES,
                            height=RES, **kw))


def _ours(build, layers=1):
    from arkoserenderer_torch.models.standard import Renderer as TRenderer

    _, tcfg = _cfgs()
    r = TRenderer(*build("torch"), tcfg, device="cpu", taa=False, bloom=False,
                  oit_layers=layers)
    return r.render_frame().numpy(), r


def test_translucency_blends_not_occludes():
    """tests/test_translucent.py's first behaviour test on the port: an
    alpha-0 pane leaves the image as it was, an alpha-0.5 pane changes
    pixels, and an alpha-0.95 pane moves them strictly further."""
    img_glass, r = _ours(lambda pkg: glass(pkg, 0.5))
    assert r.cfg.scene.has_translucent
    img_clear, _ = _ours(lambda pkg: glass(pkg, 0.0))
    img_none, _ = _ours(lambda pkg: glass(pkg, None))
    assert np.abs(img_clear - img_none).mean() < 2e-3
    diff = np.abs(img_glass - img_none).mean(-1)
    changed = diff > 0.02
    assert changed.any()
    img_dense, _ = _ours(lambda pkg: glass(pkg, 0.95))
    d_05 = np.abs(img_glass - img_none).mean(-1)[changed].mean()
    d_95 = np.abs(img_dense - img_none).mean(-1)[changed].mean()
    assert d_05 < 0.75 * d_95, (d_05, d_95)


def test_depth_peeled_oit_shows_second_layer():
    """tests/test_translucent.py's second behaviour test on the port: the
    back pane, hidden from one layer, shows with four."""
    base1, _ = _ours(lambda pkg: glass_panes(pkg, False), 1)
    both1, _ = _ours(lambda pkg: glass_panes(pkg, True), 1)
    base4, _ = _ours(lambda pkg: glass_panes(pkg, False), 4)
    both4, _ = _ours(lambda pkg: glass_panes(pkg, True), 4)
    assert np.isfinite(both4).all()
    d1 = np.abs(both1 - base1).max(-1)
    d4 = np.abs(both4 - base4).max(-1)
    assert ((d4 > 0.02) & (d1 <= 0.002)).sum() > 40


def test_translucent_casters_are_left_out_of_the_shadow_maps():
    """Translucent triangles cast no shadow: with the pane's instance made
    invalid, the sun and spot maps stay as they were; an opaque pane's
    maps differ."""
    from arkoserenderer_torch.models.standard import Renderer as TRenderer
    from arkoserenderer_torch.scene.lights import SpotLight
    from arkoserenderer_torch.scene.scene import BLEND_OPAQUE

    def renderer(blend=None):
        scene, cam = glass("torch", 0.5)
        if blend is not None:
            scene.materials[-1] = dataclasses.replace(scene.materials[-1], blend_mode=blend)
        scene.spots.append(SpotLight(position=np.array([-2.0, 3.0, 2.5], np.float32),
                                     direction=np.array([0.0, -1.0, -0.3], np.float32),
                                     luminous_intensity_cd=50000.0))
        _, tcfg = _cfgs()
        r = TRenderer(scene, cam, dataclasses.replace(tcfg, local_shadow_map_size=64),
                      device="cpu", taa=False, bloom=False)
        r.render_frame()
        return r, (r.state["ShadowMap.sun"].clone(), r.state["ShadowMap.locals"].clone())

    r, with_pane = renderer()
    valid = r.scene_arrays.inst_valid.clone()
    valid[len(r.scene.instances) - 1] = False
    r.scene_arrays = r.scene_arrays._replace(inst_valid=valid)  # bumps the sun map's version
    r.render_frame()
    assert torch.equal(r.state["ShadowMap.sun"], with_pane[0])
    assert torch.equal(r.state["ShadowMap.locals"], with_pane[1])
    assert (with_pane[1] > 0).float().mean() > 0.2
    _, opaque = renderer(BLEND_OPAQUE)
    assert not torch.equal(opaque[0], with_pane[0]) and not torch.equal(opaque[1], with_pane[1])
