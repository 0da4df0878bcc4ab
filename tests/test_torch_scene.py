"""The port's host side against the JAX package's: scene pools, camera
state, the bridge, and the port's independence from JAX.

Tolerances: ints, bools and the packed texel rows equal; floats to 1e-6
(both packages build them with the same numpy code, so in practice they are
equal too; the camera's view-projection products are f32 matmuls on two
backends, hence the tolerance).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets.procedural import build_bindless_scene as t_build_bindless_scene
from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_tpu.assets.procedural import build_bindless_scene as j_build_bindless_scene
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene

ROOT = Path(__file__).resolve().parents[1]


def assert_field_equal(name, ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    if ref.dtype == np.uint32:
        ours = ours.view(np.uint32)
    assert ours.shape == ref.shape, name
    if np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6, err_msg=name)
    else:
        assert ours.dtype == ref.dtype, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)


@pytest.fixture(scope="module")
def both_scenes():
    js, jc = j_build_test_scene(viewport=(96, 64))
    ts, tc = t_build_test_scene(viewport=(96, 64))
    return js, jc, ts, tc


def test_scene_arrays_match_jax(both_scenes):
    js, _, ts, _ = both_scenes
    ref = bridge.numpy_fields(js.build())
    ours = bridge.numpy_fields(ts.build("cpu"))
    assert set(ours) <= set(ref)
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    assert (ours["mat_tex.rows"] != 0).any()


def test_static_info_matches_jax(both_scenes):
    js, _, ts, _ = both_scenes
    ref, ours = js.static_info(), ts.static_info()
    for f in type(ours).__dataclass_fields__:
        assert getattr(ours, f) == getattr(ref, f), f


@pytest.mark.parametrize("frames", [4])
def test_camera_state_matches_jax(both_scenes, frames):
    _, jc, _, tc = both_scenes
    for i in range(frames):
        ref, ours = jc.state(i), tc.state(i, "cpu")
        for f in ref._fields:
            assert_field_equal(f, getattr(ours, f), getattr(ref, f))
        for p in ("view_proj", "unjittered_view_proj", "prev_view_proj"):
            assert_field_equal(p, getattr(ours, p), getattr(ref, p))
        jc.post_render()
        tc.post_render()
        if i == 0:
            tc.look_at((4.5, 2.5, 5.0), (0.0, 0.6, -0.5))  # move: prev != current
            jc.look_at((4.5, 2.5, 5.0), (0.0, 0.6, -0.5))


@pytest.mark.parametrize("method", ["set_field_of_view_x", "update_auto_exposure",
                                    "film_grain_gain", "frustum_planes"])
def test_camera_methods_match_jax(both_scenes, method):
    """The host camera's methods give the reference's values on the same
    camera (a fresh one each, so the auto exposure starts unset)."""
    import copy

    _, jc, _, tc = both_scenes
    jc, tc = copy.deepcopy(jc), copy.deepcopy(tc)
    if method == "set_field_of_view_x":
        for cam in (jc, tc):
            cam.set_field_of_view_x(1.1)
        assert tc.focal_length_mm == jc.focal_length_mm
        assert tc.field_of_view_x() == jc.field_of_view_x()
        np.testing.assert_array_equal(tc.projection_matrix(), jc.projection_matrix())
    elif method == "update_auto_exposure":
        # Adapting over frames: a bright, a dim and a black metering.
        for lum, dt in ((5.0, 1 / 60), (0.05, 1 / 30), (0.0, 1 / 60), (2.0, 0.5)):
            assert tc.update_auto_exposure(lum, dt) == jc.update_auto_exposure(lum, dt)
    elif method == "film_grain_gain":
        for iso in (100.0, 400.0, 3200.0):
            tc.iso = jc.iso = iso
            assert tc.film_grain_gain() == jc.film_grain_gain()
    else:
        ours, ref = tc.frustum_planes(), jc.frustum_planes()
        assert ours.shape == (6, 4) and ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)


def test_bridge_round_trip(both_scenes):
    js, jc, ts, tc = both_scenes
    carried = bridge.scene_arrays_from_numpy(js.build()._asdict(), "cpu")
    built = ts.build("cpu")
    for name, ours in bridge.numpy_fields(carried).items():
        np.testing.assert_array_equal(ours, bridge.numpy_fields(built)[name], err_msg=name)
    jstate = jc.state(2)
    cam = bridge.camera_state_from_numpy(jstate._asdict(), "cpu")
    for f in jstate._fields:
        np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jstate, f)))
    # Copies, not views: editing the source leaves the carried tensor alone.
    src = {"positions": np.ones((3, 3), np.float32)}
    fields = bridge.numpy_fields(src)
    fields["positions"][0, 0] = 5.0
    assert src["positions"][0, 0] == 1.0


def test_local_lights_are_rejected():
    """Beyond the pools' capacity, that is: within it they build."""
    from arkoserenderer_torch.scene.lights import SpotLight

    scene, _ = t_build_test_scene()
    down = np.array([0.0, -1.0, 0.0], np.float32)
    scene.spots = [SpotLight(position=np.array([i, 3.0, 0.0], np.float32), direction=down)
                   for i in range(scene.limits.max_spot_lights)]
    assert int(scene.build("cpu").lights.spot_count) == scene.limits.max_spot_lights
    scene.spots.append(scene.spots[0])
    with pytest.raises(ValueError):
        scene.build("cpu")


def _local_lights(mod):
    """Two spots (one with an IES profile and no shadow) and two points."""
    ies = np.linspace(1.0, 0.2, 256).astype(np.float32)
    spots = [
        mod.SpotLight(position=np.array([1.5, 3.0, 1.0], np.float32),
                      direction=np.array([-0.3, -1.0, -0.2], np.float32),
                      luminous_intensity_cd=30000.0),
        mod.SpotLight(position=np.array([-2.0, 4.0, 0.5], np.float32),
                      direction=np.array([0.0, -1.0, 0.0], np.float32),  # straight down
                      color=np.array([1.0, 0.8, 0.6], np.float32), cast_shadows=False,
                      inner_cone_angle=np.radians(10.0), outer_cone_angle=np.radians(50.0),
                      ies_lut=ies, source_radius=0.1),
    ]
    points = [
        mod.PointLight(position=np.array([0.0, 2.0, 2.0], np.float32)),
        mod.PointLight(position=np.array([3.0, 1.0, -1.0], np.float32), cast_shadows=True,
                       color=np.array([0.2, 0.4, 1.0], np.float32), source_radius=0.05),
    ]
    return spots, points


def test_local_light_lanes_match_jax():
    """Spot, point and IES lanes of LightArrays, the spots' shadow matrices
    and the static shadow-caster facts, through the bridge."""
    import arkoserenderer_torch.scene.lights as tlights
    import arkoserenderer_tpu.scene.lights as jlights

    js, _ = j_build_test_scene(viewport=(96, 64))
    ts, _ = t_build_test_scene(viewport=(96, 64))
    js.spots, js.points = _local_lights(jlights)
    ts.spots, ts.points = _local_lights(tlights)
    ref = bridge.numpy_fields(js.build().lights)
    ours = bridge.numpy_fields(ts.build("cpu").lights)
    assert set(ours) == set(ref)
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    assert ours["spot_count"] == 2 and ours["point_count"] == 2
    assert (ours["spot_ies"][1] < 1).any() and ours["spot_casts_shadow"][:2].tolist() == [1, 0]
    carried = bridge.scene_arrays_from_numpy(js.build()._asdict(), "cpu").lights
    for name, value in bridge.numpy_fields(carried).items():
        np.testing.assert_array_equal(value, ref[name], err_msg=name)
    jst, tst = js.static_info(), ts.static_info()
    assert tst.spot_shadow_casters == (True, False) and tst.point_shadow_casters == (False, True)
    for f in type(tst).__dataclass_fields__:
        assert getattr(tst, f) == getattr(jst, f), f


def test_bindless_scene_matches_jax():
    """Equal pools (materials, packed texel rows, records) at 16 materials
    over 4 texture chains."""
    js, jc = j_build_bindless_scene(n_materials=16, n_textures=4, viewport=(96, 64))
    ts, tc = t_build_bindless_scene(n_materials=16, n_textures=4, viewport=(96, 64))
    ref = bridge.numpy_fields(js.build())
    ours = bridge.numpy_fields(ts.build("cpu"))
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    assert len(ts.materials) == 18 and len(ts.images) == 4 + 4 + 2 + 2
    jst, tst = js.static_info(), ts.static_info()
    for f in type(tst).__dataclass_fields__:
        assert getattr(tst, f) == getattr(jst, f), f
    for f in jc.state(0)._fields:
        assert_field_equal(f, getattr(tc.state(0, "cpu"), f), getattr(jc.state(0), f))


UNPORTED = [("rt_shadows", True), ("rt_reflections", True), ("ddgi", True),
            ("ddgi_probe_debug", True), ("light_icons", True), ("debug_draw", object())]
# Flags this test held as unported that are ported since, with a value that
# turns them on: each builds its pass and matches the reference's pipeline.
PORTED_FLAGS = [("oit_layers", 2)]
# The debug overlays, ported since: each flag builds its overlay pass last,
# in the reference's pipeline order (DDGIProbeDebug only with DDGI).
PORTED_OVERLAYS = {"ddgi_probe_debug": "DDGIProbeDebug", "light_icons": "IconBillboards",
                   "debug_draw": "DebugDraw"}
# Flags that were ported in part, with the config change whose branch this
# test held as unported: half-rate ray tracing (of RT shadows and of RT
# reflections) and reduced-rate DDGI sampling, all ported since (as soft
# ray-traced shadows, the branch rt_shadows named here before): each builds
# the reference's pipeline under the change.
PARTLY_PORTED = {"rt_shadows": {"rt_scale": 2},
                 "rt_reflections": {"rt_scale": 2},
                 "ddgi": {"ddgi_sample_scale": 2}}


@pytest.mark.parametrize("flag,value", UNPORTED, ids=[f for f, _ in UNPORTED])
def test_unported_flags_raise_by_name(flag, value):
    """The flags once ported in part build the reference's pipeline under
    the config change whose branch was not ported (half-rate ray tracing,
    reduced-rate DDGI sampling); the debug overlays build their pass last,
    as the reference's make_forward_pipeline orders them."""
    import dataclasses

    from arkoserenderer_torch.models.standard import make_forward_pipeline
    from arkoserenderer_torch.ops.ddgi import ProbeGridConfig
    from arkoserenderer_torch.rendering.passes.debugdraw import DebugLineBuffer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make
    from arkoserenderer_tpu.ops.ddgi import ProbeGridConfig as JGrid
    from arkoserenderer_tpu.rendering.passes.debugdraw import DebugLineBuffer as JBuffer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

    cfg = PipelineConfig(width=32, height=16, shadow_map_size=32)
    if flag in PORTED_OVERLAYS:
        from arkoserenderer_torch.core.types import RasterConfig
        from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig

        tile = dict(tile_h=8, tile_w=16, max_tris_per_tile=64)
        kw = {flag: DebugLineBuffer() if flag == "debug_draw" else True}
        jkw = {flag: JBuffer() if flag == "debug_draw" else True}
        if flag == "ddgi_probe_debug":
            kw["ddgi"], jkw["ddgi"] = ProbeGridConfig(), JGrid()
        names = [p.name for p in make_forward_pipeline(
            dataclasses.replace(cfg, raster=RasterConfig(**tile)), device="cpu", **kw).passes]
        ref = [p.name for p in j_make(JPipelineConfig(
            width=32, height=16, shadow_map_size=32, raster=JRasterConfig(**tile)), **jkw).passes]
        assert names == ref and names[-1] == PORTED_OVERLAYS[flag]
    else:
        from arkoserenderer_torch.core.types import RasterConfig
        from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig

        tile = dict(tile_h=8, tile_w=16, max_tris_per_tile=64)
        kw = {flag: ProbeGridConfig() if flag == "ddgi" else value}
        jkw = {flag: JGrid() if flag == "ddgi" else value}
        pipe = make_forward_pipeline(dataclasses.replace(cfg, raster=RasterConfig(**tile),
                                                         **PARTLY_PORTED[flag]),
                                     device="cpu", **kw)
        ref = j_make(JPipelineConfig(width=32, height=16, shadow_map_size=32,
                                     raster=JRasterConfig(**tile), **PARTLY_PORTED[flag]), **jkw)
        assert [p.name for p in pipe.passes] == [p.name for p in ref.passes]
        field, rate = next(iter(PARTLY_PORTED[flag].items()))
        assert getattr(pipe.cfg, field) == rate
    with pytest.raises(TypeError):
        make_forward_pipeline(cfg, device="cpu", no_such_flag=True)
    assert set(PORTED_OVERLAYS) | set(PARTLY_PORTED) == {f for f, _ in UNPORTED}


@pytest.mark.parametrize("flag,value", PORTED_FLAGS, ids=[f for f, _ in PORTED_FLAGS])
def test_ported_flags_build_and_match_jax(flag, value):
    """``oit_layers``: on a scene with a translucent material both packages
    build ForwardTranslucent after SkyView with ``value`` layers, and the
    port's frame matches the JAX Renderer's (test_torch_forward.py's bound:
    2e-4 on all but 0.2 % of values, means within 1e-5)."""
    from test_torch_translucent import glass_panes
    from test_torch_translucent_frames import render_both

    tr, jr, ours, ref = render_both(lambda pkg: glass_panes(pkg, True), **{
        "layers" if flag == "oit_layers" else flag: value})
    names = [p.name for p in tr.pipeline.passes]
    assert names == [p.name for p in jr.pipeline.passes]
    assert names[names.index("SkyView") + 1] == "ForwardTranslucent"
    assert tr.pipeline.passes[names.index("ForwardTranslucent")].layers == value
    diff = np.abs(ours - ref)
    assert (diff > 2e-4).mean() < 0.002 and abs(ours.mean() - ref.mean()) < 1e-5


@pytest.mark.parametrize("keyword", ["debug_draw"])
def test_unported_renderer_keywords_raise_by_name(keyword):
    """The reference's Renderer keyword ``debug_draw``, ported since: on, the
    Renderer keeps a line buffer and ends its pipeline with DebugDraw, as
    the reference's does; off, it has neither."""
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.passes.debugdraw import DebugLineBuffer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig

    scene, cam = t_build_test_scene(viewport=(32, 16))
    cfg = PipelineConfig(width=32, height=16, shadow_map_size=32,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64))
    on = Renderer(scene, cam, cfg, device="cpu", **{keyword: True})
    assert isinstance(on.debug, DebugLineBuffer)
    assert [p.name for p in on.pipeline.passes][-3:] == ["TAA", "Output", "DebugDraw"]
    off = Renderer(scene, cam, cfg, device="cpu", taa=False, bloom=False, **{keyword: False})
    assert off.debug is None and "DebugDraw" not in [p.name for p in off.pipeline.passes]


def test_pipelines_build_in_reference_order():
    """The reference's default flags give the nine forward passes; the
    full_post flags with fxaa and cas the fifteen; a casting spot puts
    LocalShadow after SunShadow."""
    import dataclasses

    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import make_forward_pipeline
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_torch.scene.scene import SceneStatic

    cfg = PipelineConfig(width=32, height=16, shadow_map_size=32, local_shadow_map_size=32,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64))

    def names(cfg, **kw):
        return [p.name for p in make_forward_pipeline(cfg, device="cpu", **kw).passes]

    forward = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
               "SkyView", "Bloom", "TAA", "Output"]
    assert names(cfg) == forward
    assert names(cfg, ssao=True, fog=True, motion_blur=True, depth_of_field=True, fxaa=True,
                 cas=True) == [
        "Scene", "Geometry", "SunShadow", "VisibilityShading", "SSAO", "LightingCompose",
        "SkyView", "Fog", "MotionBlur", "DepthOfField", "Bloom", "TAA", "Output", "FXAA", "CAS"]
    spot = dataclasses.replace(cfg, scene=SceneStatic(n_spots=2, spot_shadow_casters=(False, True)))
    assert names(spot) == forward[:3] + ["LocalShadow"] + forward[3:]
    assert names(spot, shadows=False) == forward[:2] + forward[3:]
    no_caster = dataclasses.replace(cfg, scene=SceneStatic(n_spots=1, spot_shadow_casters=(False,)))
    assert names(no_caster) == forward
    with pytest.raises(ValueError):  # 36 is no multiple of the 8x16 tile
        names(dataclasses.replace(spot, local_shadow_map_size=36))


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, importlib, sys, arkoserenderer_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'arkoserenderer_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import arkoserenderer_torch.models.standard, arkoserenderer_torch.ops.raster_cuda\n"
        "import arkoserenderer_torch.tools.bench, arkoserenderer_torch.assets.meshopt\n"
        "import arkoserenderer_torch.ops.upscale, arkoserenderer_torch.rendering.passes.upscale\n"
        "import arkoserenderer_torch.ops.bvh, arkoserenderer_torch.ops.bvh_cuda\n"
        "import arkoserenderer_torch.ops.rt, arkoserenderer_torch.ops.reflection_denoise\n"
        "import arkoserenderer_torch.rendering.passes.rt, arkoserenderer_torch.tools.trace_bench\n"
        "import arkoserenderer_torch.core.prng, arkoserenderer_torch.ops.ddgi\n"
        "import arkoserenderer_torch.rendering.passes.ddgi\n"
        "import arkoserenderer_torch.scene.animation, arkoserenderer_torch.ops.skinning\n"
        "import arkoserenderer_torch.rendering.passes.ssss\n"
        "import arkoserenderer_torch.assets.imagecodec, arkoserenderer_torch.assets.gltf\n"
        "import arkoserenderer_torch.assets.sample_scenes\n"
        "import arkoserenderer_torch.ops.texture, arkoserenderer_torch.ops.pathtrace\n"
        "import arkoserenderer_torch.models.pathtracer, arkoserenderer_torch.ops.bake_ao\n"
        "import arkoserenderer_torch.ops.shadow_denoise\n"
        "import arkoserenderer_torch.apps.showcase, arkoserenderer_torch.assets.external\n"
        "import arkoserenderer_torch.utils.timing, arkoserenderer_torch.utils.memstats\n"
        "import arkoserenderer_torch.assets.ark, arkoserenderer_torch.assets.baked\n"
        "import arkoserenderer_torch.assets.bc7, arkoserenderer_torch.assets.cereal_binary\n"
        "import arkoserenderer_torch.core.logging, arkoserenderer_torch.tools.ark_level\n"
        "import arkoserenderer_torch.rendering.passes.translucent\n"
        "import arkoserenderer_torch.core.taskgraph, arkoserenderer_torch.rendering.streaming\n"
        "import arkoserenderer_torch.rendering.passes.debugdraw\n"
        "import arkoserenderer_torch.rendering.passes.debugviz\n"
        "import arkoserenderer_torch.rendering.passes.icons\n"
        "import arkoserenderer_torch.rendering.passes.ddgi_debug\n"
        "import arkoserenderer_torch.apps.humandemo, arkoserenderer_torch.apps.meshviewer\n"
        "import arkoserenderer_torch.apps.geodata\n"
        "import arkoserenderer_torch.apps.viewer, arkoserenderer_torch.system.webviewer\n"
        "import arkoserenderer_torch.system.input, arkoserenderer_torch.system.system\n"
        "import arkoserenderer_torch.scene.controllers, arkoserenderer_torch.scene.editor\n"
        "import arkoserenderer_torch.physics.backend, arkoserenderer_torch.utils.hotreload\n"
        "import arkoserenderer_torch.utils.profiling\n"
        "import arkoserenderer_torch.tools.cooker, arkoserenderer_torch.tools.bake\n"
        "import arkoserenderer_torch.tools.arkbake, arkoserenderer_torch.tools.gen_bluenoise\n"
        "import arkoserenderer_torch.ops.raster_reference\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('arkoserenderer_tpu') or k == 'PIL'\n"
        "             or k.startswith('PIL.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 90  # every module of the slices was imported


def test_renderer_device_is_explicit():
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig

    scene, cam = t_build_test_scene(viewport=(32, 16))
    cfg = PipelineConfig(width=32, height=16, shadow_map_size=32,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64))
    r = Renderer(scene, cam, cfg, device="cpu", taa=False, bloom=False)
    assert all(t.device == torch.device("cpu") for t in bridge_tensors(r.scene_arrays))
    full = Renderer(scene, cam, cfg, device="cpu")  # TAA and bloom default on
    assert full.pipeline.initial_state()["TAAHistory"].device == torch.device("cpu")


def _entry_points():
    from arkoserenderer_torch.apps import geodata, humandemo, meshviewer, showcase
    from arkoserenderer_torch.models.standard import Renderer, make_forward_pipeline
    from arkoserenderer_torch.rendering.pipeline import RenderPipeline
    from arkoserenderer_torch.scene.camera import Camera
    from arkoserenderer_torch.scene.scene import Scene
    from arkoserenderer_torch.utils import memstats

    return {"Renderer": Renderer.__init__, "make_forward_pipeline": make_forward_pipeline,
            "RenderPipeline": RenderPipeline.__init__, "Scene.build": Scene.build,
            "Camera.state": Camera.state, "showcase.main": showcase.main,
            "showcase.make_renderer": showcase.make_renderer,
            "memstats.snapshot": memstats.snapshot, "humandemo.main": humandemo.main,
            "geodata.main": geodata.main, "meshviewer.main": meshviewer.main}


@pytest.mark.parametrize("name", ["Renderer", "make_forward_pipeline", "RenderPipeline",
                                  "Scene.build", "Camera.state", "showcase.main",
                                  "showcase.make_renderer", "memstats.snapshot",
                                  "humandemo.main", "geodata.main", "meshviewer.main"])
def test_entry_points_default_to_the_card(name):
    """The port runs on the card unless the caller asks for the CPU; the
    check reads the signature and builds nothing."""
    import inspect

    assert inspect.signature(_entry_points()[name]).parameters["device"].default == "cuda"


def bridge_tensors(tree):
    if hasattr(tree, "_asdict"):
        for v in tree._asdict().values():
            yield from bridge_tensors(v)
    elif isinstance(tree, tuple):  # the morph tuples, one entry per morphed instance
        for v in tree:
            yield from bridge_tensors(v)
    elif tree is not None:  # a scene built without a BVH has None
        yield tree
