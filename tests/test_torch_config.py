"""The port's PipelineConfig and OutputPass take the reference's fields.

Every field of the reference's PipelineConfig constructs at its default;
the texture qualities and shadow filters the reference takes construct;
each value the port does not implement raises NotImplementedError naming
the field (the reduced rates listed here before are ported: they build
the reference's pipeline and render); a ray-tracing or DDGI sampling rate
other than 1 and 2, which breaks the reference's frame, raises ValueError
naming the field at construction; the pixel-band sharding fields
construct as the reference's; "auto" resolves as the reference's
make_forward_pipeline resolves it. OutputPass's ``mode`` matches JAX's at 96^2 for every
tonemap operator, and VisibilityShading with ``texture_quality="bilinear"``
matches JAX's pass at 96^2 under the forward tests' tolerances
(``tests/test_torch_passes.py``).
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
from arkoserenderer_torch.ops import tonemap as t_tonemap
from arkoserenderer_torch.rendering.passes.output import OutputPass as TOutputPass
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.rendering.registry import Registry as TRegistry
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.rendering.passes.output import OutputPass as JOutputPass
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from arkoserenderer_tpu.rendering.registry import Registry as JRegistry
from test_torch_passes import COLOR_ATOL, RASTER, compare

torch.set_num_threads(2)

RES = 96
REFERENCE_FIELDS = ["texture_quality", "shading_mode", "shadow_filter", "sky_fetch_scale",
                    "ddgi_sample_scale", "shard_axis", "full_height", "shard_count"]
# (field, value) the port does not implement; each raises naming the field.
UNPORTED = [("texture_quality", "sorted"), ("sky_fetch_scale", 2),
            ("ddgi_sample_scale", 2)]
# Of those, ported since they were listed: each builds the reference's
# pipeline (the DDGI rate with a probe grid).
PORTED_SINCE = ("sky_fetch_scale", "ddgi_sample_scale", "texture_quality")
# The pixel-band sharding fields (parallel/sharded.py), each taken as the
# reference takes it.
SHARDING = [("shard_axis", "x"), ("shard_count", 2), ("full_height", 2 * RES)]
# The rest of the config a listed value needs: "sorted" was unported only
# under the reference shading mode (the packed mode takes it as trilinear).
UNPORTED_WITH = {"texture_quality": {"shading_mode": "reference"}}


@pytest.mark.parametrize("field", REFERENCE_FIELDS + ["frame_height", "num_pixels"])
def test_reference_fields_construct_at_their_defaults(field):
    ours = TPipelineConfig(width=RES, height=RES)
    ref = JPipelineConfig(width=RES, height=RES)
    assert getattr(ours, field) == getattr(ref, field)


@pytest.mark.parametrize("field,value", UNPORTED, ids=[f"{f}={v}" for f, v in UNPORTED])
def test_unported_values_raise_by_name(field, value):
    base = UNPORTED_WITH.get(field, {})
    JPipelineConfig(width=RES, height=RES, **base, **{field: value})  # the reference takes it
    if field in PORTED_SINCE:
        from arkoserenderer_torch.ops.ddgi import ProbeGridConfig
        from arkoserenderer_tpu.ops.ddgi import ProbeGridConfig as JGrid

        sizes = dict(width=32, height=16, shadow_map_size=32)
        tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), **sizes, **base,
                               **{field: value})
        jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), **sizes, **base,
                               **{field: value})
        kw, jkw = ((dict(ddgi=ProbeGridConfig()), dict(ddgi=JGrid()))
                   if field == "ddgi_sample_scale" else ({}, {}))
        names = [p.name for p in t_make_pipeline(tcfg, device="cpu", **kw).passes]
        assert names == [p.name for p in j_make_pipeline(jcfg, **jkw).passes]
        assert getattr(dataclasses.replace(TPipelineConfig(), **{field: value}), field) == value
        return
    with pytest.raises(NotImplementedError, match=field):
        TPipelineConfig(width=RES, height=RES, **base, **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        dataclasses.replace(TPipelineConfig(width=RES, height=RES, **base), **{field: value})


@pytest.mark.parametrize("field,value", SHARDING, ids=[f"{f}={v}" for f, v in SHARDING])
def test_sharding_values_construct_as_the_reference(field, value):
    ours = TPipelineConfig(width=RES, height=RES, **{field: value})
    ref = JPipelineConfig(width=RES, height=RES, **{field: value})
    assert getattr(ours, field) == getattr(ref, field) == value
    assert ours.frame_height == ref.frame_height and ours.height == RES


@pytest.mark.parametrize("field,value", [("texture_quality", "trilinear"),
                                         ("texture_quality", "bilinear"),
                                         ("texture_quality", "aniso4"),
                                         ("texture_quality", "aniso16"),
                                         ("texture_quality", "stochastic"),
                                         ("texture_quality", "stochastic1"),
                                         ("texture_quality", "sorted"),
                                         ("shadow_filter", "bilinear"),
                                         ("shadow_filter", "stochastic"),
                                         ("shading_mode", "reference"), ("full_height", RES),
                                         ("shard_count", 1), ("sky_fetch_scale", 1),
                                         ("sky_fetch_scale", 2), ("sky_fetch_scale", 3),
                                         ("rt_scale", 2), ("ddgi_sample_scale", 2)])
def test_ported_values_construct(field, value):
    cfg = TPipelineConfig(width=RES, height=RES, **{field: value})
    assert getattr(cfg, field) == value and cfg.frame_height == RES
    with pytest.raises(ValueError):
        TPipelineConfig(texture_quality="no_such_filter")


def test_auto_resolves_as_the_reference():
    """make_forward_pipeline resolves "auto" to trilinear textures and the
    bilinear VSM, as the reference's does, and keeps an explicit value."""
    scene, _ = t_build_test_scene(viewport=(32, 32))
    jscene, _ = j_build_test_scene(viewport=(32, 32))
    for explicit in ({}, dict(texture_quality="bilinear", shadow_filter="bilinear")):
        tcfg = TPipelineConfig(width=32, height=32, shadow_map_size=32,
                               raster=TRasterConfig(**RASTER), scene=scene.static_info(),
                               **explicit)
        jcfg = JPipelineConfig(width=32, height=32, shadow_map_size=32,
                               raster=JRasterConfig(**RASTER), scene=jscene.static_info(),
                               **explicit)
        ours = t_make_pipeline(tcfg, device="cpu").cfg
        ref = j_make_pipeline(jcfg).cfg
        assert (ours.texture_quality, ours.shadow_filter) == (ref.texture_quality,
                                                              ref.shadow_filter)
    assert t_make_pipeline(dataclasses.replace(tcfg, texture_quality="auto"),
                           device="cpu").cfg.texture_quality == "trilinear"


REGISTRY_PIPELINES = {"forward": {}, "full_post": dict(ssao=True, fog=True, motion_blur=True,
                                                    depth_of_field=True),
                      "rt": dict(rt_shadows=True, rt_reflections=True)}


@pytest.mark.parametrize("kind", sorted(REGISTRY_PIPELINES))
def test_registry_and_describe_match_jax(kind):
    """Registry.dependency_edges, clear_value and describe, and
    RenderPipeline.describe, of one pipeline built by both packages at
    32x32: the same edges and clear values, the same description line for
    line, but that the port's host-held version counters read "host" where
    the reference's int32 scalars read "int32"."""
    from arkoserenderer_torch.rendering.passes.rt import RTShadowPass

    scene, _ = t_build_test_scene(viewport=(32, 32), n_spheres=1)
    jscene, _ = j_build_test_scene(viewport=(32, 32), n_spheres=1)
    sizes = dict(width=32, height=32, shadow_map_size=32)
    tp = t_make_pipeline(TPipelineConfig(raster=TRasterConfig(**RASTER), scene=scene.static_info(),
                                         **sizes), device="cpu", **REGISTRY_PIPELINES[kind])
    jp = j_make_pipeline(JPipelineConfig(raster=JRasterConfig(**RASTER),
                                         scene=jscene.static_info(), **sizes),
                         **REGISTRY_PIPELINES[kind])
    treg, jreg = tp.registry, jp.registry
    assert treg.dependency_edges() == jreg.dependency_edges() and treg.dependency_edges()
    ours, ref = tp.describe().splitlines(), jp.describe().splitlines()
    assert ours[0] == ref[0] == "pipeline [" + " -> ".join(p.name for p in tp.passes) + "]"
    assert len(ours) == len(ref) == 1 + len(treg._resources)
    for a, b in zip(ours[1:], ref[1:]):
        name = a.split()[1]
        if treg.desc(name).dtype is None:
            assert a.replace(" host      ", " int32     ") == b, (a, b)
            assert treg.clear_value(name) == int(jreg.clear_value(name))
        else:
            assert a == b
            np.testing.assert_array_equal(treg.clear_value(name, "cpu").numpy(),
                                          np.asarray(jreg.clear_value(name)), err_msg=name)
    if kind == "rt":
        assert ("Geometry", "RTShadow") in treg.dependency_edges()
        assert isinstance(tp.passes[2], RTShadowPass)


DDGI_UNPORTED = ["ddgi_probe_debug", "ddgi_sample_scale", "hair"]
# Rates the reference's nearest-depth upsample (2x) cannot take: at 48x48
# its passes take them and fail on a shape when traced.
BAD_RATES = [("rt_scale", 3), ("rt_scale", 4), ("ddgi_sample_scale", 3)]


@pytest.mark.parametrize("field,value", BAD_RATES, ids=[f"{f}={v}" for f, v in BAD_RATES])
def test_rates_the_reference_cannot_run_raise(field, value):
    """The reference's pass at this rate (RTShadow, or LightingCompose with
    DDGI) fails on a shape when traced (jax.eval_shape on the registry's
    shapes, nothing compiled); the port refuses the value at construction
    with a ValueError naming the field, and 0 and 4 too."""
    from arkoserenderer_tpu.assets.procedural import build_test_scene
    from arkoserenderer_tpu.ops.ddgi import ProbeGridConfig as JGrid

    scene, cam = build_test_scene(viewport=(48, 48), n_spheres=1)
    cfg = JPipelineConfig(width=48, height=48, shadow_map_size=32, raster=JRasterConfig(**RASTER),
                          scene=scene.static_info(), **{field: value})
    rt = field == "rt_scale"
    pipe = j_make_pipeline(cfg, taa=False, bloom=False,
                           **(dict(rt_shadows=True) if rt else dict(ddgi=JGrid())))
    state = {r.name: jax.ShapeDtypeStruct(r.shape, r.dtype)
             for r in pipe.registry._resources.values()}
    ctx = JFrameContext(scene=scene.build(with_bvh=True) if rt else None, camera=cam.state(0),
                        frame_index=jnp.asarray(0, jnp.int32),
                        delta_time=jnp.asarray(1 / 60, jnp.float32),
                        row_offset=jnp.zeros((), jnp.int32))
    execute = dict(pipe._executes)["RTShadow" if rt else "LightingCompose"]
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(execute, state, ctx)
    for v in (value, 0, 4):
        with pytest.raises(ValueError, match=field):
            TPipelineConfig(width=48, height=48, **{field: v})
        with pytest.raises(ValueError, match=field):
            dataclasses.replace(TPipelineConfig(width=48, height=48), **{field: v})


@pytest.mark.parametrize("option", DDGI_UNPORTED)
def test_unported_ddgi_options_raise_by_name(option):
    """DDGI is ported, and so are its probe overlay and a hair scene under
    it: the overlay builds DDGIProbeDebug last, and the hair scene's DDGI
    Renderer constructs as the reference's does (tracing the BVH as
    built). Its reduced-rate sampling, ported since, renders a frame with
    the reference's passes. Without them the same DDGI frame builds."""
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops.ddgi import ProbeGridConfig

    scene, cam = t_build_test_scene(viewport=(32, 16))
    cfg = TPipelineConfig(width=32, height=16, shadow_map_size=32,
                          raster=TRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64),
                          scene=scene.static_info())
    grid = ProbeGridConfig()
    if option == "ddgi_probe_debug":
        names = [p.name for p in t_make_pipeline(cfg, device="cpu", ddgi=grid,
                                                 ddgi_probe_debug=True).passes]
        assert names[2] == "DDGI" and names[-1] == "DDGIProbeDebug"
        assert "DDGIProbeDebug" not in [p.name for p in t_make_pipeline(
            cfg, device="cpu", ddgi_probe_debug=True).passes]  # without DDGI: no overlay
    elif option == "ddgi_sample_scale":
        half = Renderer(scene, cam, dataclasses.replace(cfg, ddgi_sample_scale=2), device="cpu",
                        ddgi=True, taa=False, bloom=False)
        assert half.pipeline.cfg.ddgi_sample_scale == 2
        img = half.render_frame()
        assert img.shape == (16, 32, 3) and bool(torch.isfinite(img).all())
        assert [p.name for p in half.pipeline.passes][:3] == ["Scene", "Geometry", "DDGI"]
    else:
        hair = dataclasses.replace(scene.static_info(), has_hair=True)
        scene.static_info = lambda: hair
        r = Renderer(scene, cam, cfg, device="cpu", ddgi=True)
        assert r.cfg.scene.has_hair and "BVHRefit" not in [p.name for p in r.pipeline.passes]
        scene.static_info = lambda: dataclasses.replace(hair, has_hair=False)
    r = Renderer(scene, cam, cfg, device="cpu", ddgi=True)
    assert [p.name for p in r.pipeline.passes][:3] == ["Scene", "Geometry", "DDGI"]
    assert r.scene_arrays.bvh is not None  # DDGI alone builds the BVH
    with pytest.raises(TypeError, match="ProbeGridConfig"):
        t_make_pipeline(cfg, device="cpu", ddgi=True)


@pytest.mark.parametrize("case", ["ssss", "rt_refit", "hair", "ssss_temporal"])
def test_ssss_and_refit_construct_and_their_unported_branches_raise(case):
    """``ssss`` and ``rt_refit`` are ported and construct in the reference's
    places (SSSS after LightingCompose, BVHRefit after Geometry when a pass
    traces rays); a hair scene, ported since, builds the reference's
    forward passes with the sun map rastered every frame. SSSS's temporal
    branch constructs when asked for, and under the stochastic texture
    qualities by default."""
    from arkoserenderer_torch.rendering.passes.ssss import SSSSPass
    from arkoserenderer_torch.scene.scene import SceneStatic

    cfg = TPipelineConfig(width=32, height=16, shadow_map_size=32,
                          raster=TRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64))

    def names(cfg, **kw):
        return [p.name for p in t_make_pipeline(cfg, device="cpu", **kw).passes]

    if case == "ssss":
        assert names(cfg, ssss=True)[4:7] == ["LightingCompose", "SSSS", "SkyView"]
    elif case == "rt_refit":
        assert "BVHRefit" not in names(cfg, rt_refit=True)  # nothing traces rays
        assert names(cfg, rt_refit=True, rt_shadows=True)[:4] == [
            "Scene", "Geometry", "BVHRefit", "RTShadow"]
    elif case == "hair":
        pipe = t_make_pipeline(dataclasses.replace(cfg, scene=SceneStatic(has_hair=True)),
                               device="cpu")
        assert [p.name for p in pipe.passes][:4] == ["Scene", "Geometry", "SunShadow",
                                                     "VisibilityShading"]
        assert "ShadowMap.sun" not in pipe.registry.persistent_names
    else:
        for sto_cfg, kw in ((cfg, dict(temporal=True)),
                            (dataclasses.replace(cfg, texture_quality="stochastic1"), {})):
            reg = TRegistry()
            for name, shape in (("SceneColor", (16, 32, 3)), ("SceneMaterial", (16, 32, 4)),
                                ("SceneDepth", (16, 32))):
                reg.create(name, shape, torch.float32)
            assert callable(SSSSPass(**kw).construct(sto_cfg, reg, torch.device("cpu")))
        assert names(dataclasses.replace(cfg, texture_quality="stochastic"),
                     ssss=True)[4:7] == ["LightingCompose", "SSSS", "SkyView"]


def test_output_pass_takes_the_reference_keywords():
    from arkoserenderer_torch.assets.external import CubeLUT

    TOutputPass(mode="agx", vignette_intensity=0.0, film_grain_gain=0.1)
    lut = CubeLUT.identity(4)
    assert TOutputPass(color_grade_lut=lut).color_grade_lut is lut


@pytest.mark.parametrize("mode", sorted(t_tonemap.MODES))
def test_output_mode_matches_jax(mode):
    """OutputPass(mode=...) against JAX's on the same 96^2 HDR SceneColor,
    with vignette and film grain; the config's tonemap_mode differs, so
    the pass's own mode is what selects the operator."""
    rng = np.random.default_rng(5)
    color = np.exp(rng.normal(-0.5, 1.5, (RES, RES, 3))).astype(np.float32)
    kw = dict(mode=mode, vignette_intensity=0.18, film_grain_gain=0.05)
    other = "clamp" if mode != "clamp" else "agx"
    tcfg = TPipelineConfig(width=RES, height=RES, tonemap_mode=other)
    jcfg = JPipelineConfig(width=RES, height=RES, tonemap_mode=other)
    outs = []
    for reg, cfg, make, state, ctx in (
        (TRegistry(), tcfg, lambda r, c: TOutputPass(**kw).construct(c, r, torch.device("cpu")),
         {"SceneColor": torch.from_numpy(color)},
         TFrameContext(scene=None, camera=None, frame_index=3, delta_time=1 / 60)),
        (JRegistry(), jcfg, lambda r, c: jax.jit(JOutputPass(**kw).construct(c, r)),
         {"SceneColor": jnp.asarray(color)},
         JFrameContext(scene=None, camera=None, frame_index=jnp.asarray(3, jnp.int32),
                       delta_time=jnp.asarray(1 / 60, jnp.float32),
                       row_offset=jnp.zeros((), jnp.int32))),
    ):
        reg.set_current_node("Source")
        reg.create("SceneColor", (RES, RES, 3), None)
        reg.set_current_node("Output")
        outs.append(make(reg, cfg)(state, ctx))
    ours, ref = outs
    for key in ("LDR", "Metering.avgLum"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=COLOR_ATOL[key], rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def bilinear_walk():
    """The forward slice's passes up to VisibilityShading with
    texture_quality="bilinear", JAX's outputs fed to both sides."""
    jscene, jcam = j_build_test_scene(viewport=(RES, RES))
    tscene, _ = t_build_test_scene(viewport=(RES, RES))
    sizes = dict(width=RES, height=RES, shadow_map_size=128, texture_quality="bilinear")
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    jpipe = j_make_pipeline(jcfg, taa=False, bloom=False)
    tpipe = t_make_pipeline(tcfg, taa=False, bloom=False, device="cpu")
    jsa, jcs = jscene.build(), jcam.state(0)
    tctx = TFrameContext(scene=bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu"),
                         camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                         frame_index=0, delta_time=1 / 60)
    jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(0, jnp.int32),
                         delta_time=jnp.asarray(1 / 60, jnp.float32),
                         row_offset=jnp.zeros((), jnp.int32))
    state = jpipe.initial_state()
    state["scene.version"] = jnp.asarray(0, jnp.int32)
    out = {}
    for (name, jexec), (_, texec) in zip(jpipe._executes, tpipe._executes):
        out[name] = (texec(bridge.frame_state_from_numpy(state, "cpu"), tctx),
                     jax.jit(jexec)(state, jctx))
        state = {**state, **out[name][1]}
        if name == "VisibilityShading":
            break
    return out


def test_bilinear_visibility_shading_matches_jax(bilinear_walk):
    tupd, jupd = bilinear_walk["VisibilityShading"]
    assert set(tupd) == set(jupd)
    vis_agree = (bilinear_walk["Geometry"][0]["Visibility"].numpy()
                 == np.asarray(bilinear_walk["Geometry"][1]["Visibility"]))
    for key in sorted(jupd):
        compare(key, tupd[key], jupd[key], vis_agree)
    base = tupd["SceneBaseColor"].numpy()
    assert np.isfinite(base).all() and base[vis_agree].std() > 0
