"""The port's DDGI frames against the JAX package's: the `ddgi` golden's
pipeline (one sphere, the default 8x4x8 probe grid, TAA and Bloom) and the
`showcase` pipeline (the same scene and grid with rt_shadows,
rt_reflections, SSAO, Fog and MotionBlur) pass by pass at 96^2 over two
frames of a moving camera, frame 0's persistent state fed to frame 1, and
LightingCompose at ``ddgi_sample_scale=2`` on the same input states; the
`ddgi` and `showcase` goldens at 256^2; the flagship scene's pools against
JAX's at the bench's small size (256 spheres, 64 materials, 16 texture
chains); and the bench's showcase and flagship kinds at 256^2 on the CPU.

The walk is test_torch_rt.py's: each torch pass gets the JAX input state of
that pass. Tolerances are test_torch_rt.py's (and test_torch_passes.py's),
plus:
  * DDGI.irradiance, DDGI.visibility and DDGI.offsets: test_torch_ddgi.py's
    (irradiance 1e-5, visibility 1e-5 of its magnitude, on all but 0.5 % of
    the values, for a probe ray's hit can flip on an ulp; offsets 1e-6);
  * SSAO's occlusion tests flip samples on an ulp, as in the full_post
    walk (test_torch_passes.py's bound: under 1 % of the pixels over 1e-4,
    none over 1).
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
from arkoserenderer_tpu.ops import ddgi as jdd
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_ddgi import _assert_atlas_close
from test_torch_passes import RASTER, RES, _np, _torch_state, compare, compare_flips
from test_torch_rt import compare_rt

torch.set_num_threads(2)

WALK_PASSES = {
    "ddgi": ["Scene", "Geometry", "DDGI", "SunShadow", "VisibilityShading", "LightingCompose",
             "SkyView", "Bloom", "TAA", "Output"],
    "showcase": ["Scene", "Geometry", "DDGI", "RTShadow", "VisibilityShading", "RTReflections",
                 "SSAO", "LightingCompose", "SkyView", "Fog", "MotionBlur", "Bloom", "TAA",
                 "Output"],
}
WALK_KW = {
    "ddgi": {},
    "showcase": dict(rt_shadows=True, rt_reflections=True, ssao=True, fog=True,
                     motion_blur=True),
}
DDGI_KEYS = ("DDGI.irradiance", "DDGI.visibility", "DDGI.offsets")
# (pipeline, pass, resource) -> (bound, share of values allowed over it, cap on those).
FLIPS = {
    ("showcase", "SSAO", "SSAO"): (1e-4, 0.01, 1.0),
}


FRAME_TIMES = (0.0, 0.25)  # an animated scene's clip time at frames 0 and 1
# The passes both DDGI walks start with, whose JAX updates the second walk
# takes from the first (``walk``'s ``jax_shared``).
SHARED_PREFIX = ("Scene", "Geometry", "DDGI")


def walk(jscene, jcam, tscene, flags: dict, frames: int = 2, animate: bool = False,
         jax_shared: dict | None = None, reduced: dict | None = None):
    """Both packages' pipelines of ``flags`` (make_forward_pipeline's, with
    ``ddgi`` a JAX ProbeGridConfig) pass by pass over ``frames`` frames:
    {(frame, pass): (torch, jax) updates}, and "names": the passes. Each
    torch pass takes the JAX input state of that pass; the camera moves 0.4
    in x between frames and frame 0's persistent state feeds frame 1. With
    ``animate`` the JAX scene's clips are evaluated at FRAME_TIMES[frame]
    and the palette and morph weights uploaded, as Renderer does.

    ``jax_shared``: JAX updates of the passes in SHARED_PREFIX kept across
    walks of one scene, camera and grid, keyed by frame and the pass list up
    to the pass: a walk whose pipeline starts with the same passes reuses
    them (those passes read nothing the later passes or the flags set).

    ``reduced``: {pass: PipelineConfig changes}; each such pass of the
    pipelines built with the changes also runs on the pass's input state,
    as (frame, pass, "reduced")."""
    sizes = dict(width=RES, height=RES, shadow_map_size=128)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    jpipe = j_make_pipeline(jcfg, **flags)
    tflags = dict(flags)
    if "ddgi" in flags:
        tflags["ddgi"] = bridge.probe_grid_from(flags["ddgi"])
    tpipe = t_make_pipeline(tcfg, device="cpu", **tflags)
    names = [n for n, _ in jpipe._executes]
    assert names == [n for n, _ in tpipe._executes]
    variants = {}
    for name, changes in (reduced or {}).items():
        jvar = dict(j_make_pipeline(dataclasses.replace(jcfg, **changes), **flags)._executes)
        tvar = dict(t_make_pipeline(dataclasses.replace(tcfg, **changes), device="cpu",
                                    **tflags)._executes)
        variants[name] = (tvar[name], jax.jit(jvar[name]))
    persistent = sorted(jpipe.registry.persistent_names)
    assert persistent == sorted(tpipe.registry.persistent_names)
    if "ddgi" in flags:
        assert set(DDGI_KEYS) <= set(persistent)
        t_init = tpipe.initial_state()
        for key, value in jpipe.initial_state().items():
            if key in DDGI_KEYS:  # visibility cleared to max_distance in both channels
                np.testing.assert_array_equal(_np(t_init[key]), _np(value), err_msg=key)

    jsa = jscene.build(with_bvh="ddgi" in flags or flags.get("rt_shadows", False)
                       or flags.get("rt_reflections", False))
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes]
    state = jpipe.initial_state()
    out = {"names": names}
    for frame in range(frames):
        if frame:
            jcam.post_render()
            jcam.position = jcam.position + np.array([0.4, 0.0, 0.0], np.float32)
            state = {k: state[k] for k in persistent}
        if animate:
            palette = jscene.update_animations(FRAME_TIMES[frame])
            jsa = jsa._replace(palette=jnp.asarray(palette), morph_weights=tuple(
                jnp.asarray(w) for w in jscene._morph_weights_list))
        tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
        state["scene.version"] = jnp.asarray(frame if animate else 0, jnp.int32)
        jcs = jcam.state(frame)
        tctx = TFrameContext(scene=tsa, camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                             frame_index=frame, delta_time=1 / 60)
        jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(frame, jnp.int32),
                             delta_time=jnp.asarray(1 / 60, jnp.float32),
                             row_offset=jnp.zeros((), jnp.int32))
        for i, ((name, _), jexec, (_, texec)) in enumerate(
                zip(jpipe._executes, jitted, tpipe._executes)):
            tupd = texec(_torch_state(state), tctx)
            key = (frame, tuple(names[:i + 1]))
            if jax_shared is not None and key in jax_shared:
                jupd = jax_shared[key]
            else:
                jupd = jexec(state, jctx)
                if jax_shared is not None and names[:i + 1] == list(SHARED_PREFIX[:i + 1]):
                    jax_shared[key] = jupd
            out[frame, name] = (tupd, jupd)
            if name in variants:
                tvar, jvar = variants[name]
                out[frame, name, "reduced"] = (tvar(_torch_state(state), tctx),
                                               jvar(state, jctx))
            state = {**state, **jupd}
    return out


def walk_ddgi(kind, jax_shared=None):
    """Both pipelines of ``kind`` pass by pass over two frames:
    {(frame, pass): (torch, jax) updates}, with LightingCompose also at
    ``ddgi_sample_scale=2``. Both kinds walk the same scene, camera and
    grid, so they may share ``jax_shared``."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_tpu.assets.procedural as jproc

    jscene, jcam = jproc.build_test_scene(viewport=(RES, RES), n_spheres=1)
    tscene, _ = tproc.build_test_scene(viewport=(RES, RES), n_spheres=1)
    out = walk(jscene, jcam, tscene, dict(ddgi=jdd.ProbeGridConfig(), **WALK_KW[kind]),
               jax_shared=jax_shared, reduced={"LightingCompose": dict(ddgi_sample_scale=2)})
    assert out["names"] == WALK_PASSES[kind]
    return out


@pytest.fixture(scope="module")
def jax_shared():
    """The JAX updates of SHARED_PREFIX, computed by the first DDGI walk."""
    return {}


@pytest.fixture(scope="module", params=sorted(WALK_PASSES))
def ddgi_walk(request, jax_shared):
    return request.param, walk_ddgi(request.param, jax_shared)


@pytest.mark.parametrize("frame", [0, 1])
def test_ddgi_frames_match_jax(ddgi_walk, frame):
    """Every published key of every pass, the three DDGI atlases included."""
    kind, out = ddgi_walk
    geo_t, geo_j = out[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    seen = set()
    for name in WALK_PASSES[kind]:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            seen.add(key)
            flips = FLIPS.get((kind, name, key))
            if key in ("DDGI.irradiance", "DDGI.visibility"):
                _assert_atlas_close(key[5:], _np(tupd[key]), _np(jupd[key]))
            elif key == "DDGI.offsets":
                np.testing.assert_allclose(_np(tupd[key]), _np(jupd[key]), atol=1e-6, rtol=0)
            elif flips is not None:
                compare_flips(key, tupd[key], jupd[key], *flips)
            elif not compare_rt(key, tupd[key], jupd[key], vis_agree):
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    assert set(DDGI_KEYS) <= seen
    assert np.isfinite(_np(out[frame, "Output"][0]["LDR"])).all()


@pytest.mark.parametrize("frame", [0, 1])
def test_half_rate_ddgi_compose_matches_jax(ddgi_walk, frame):
    """LightingCompose sampling the probes at one pixel of each 2x2 block
    and upsampling by nearest depth: SceneColor within 1e-5 where
    Visibility agrees; the half-rate ambient is not the full-rate one."""
    kind, out = ddgi_walk
    geo_t, geo_j = out[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    tupd, jupd = out[frame, "LightingCompose", "reduced"]
    assert set(tupd) == set(jupd) == {"SceneColor"}
    o, r = _np(tupd["SceneColor"]), _np(jupd["SceneColor"])
    np.testing.assert_allclose(o[vis_agree], r[vis_agree], atol=1e-5, rtol=0, err_msg=kind)
    full = _np(out[frame, "LightingCompose"][0]["SceneColor"])
    assert np.isfinite(o).all() and np.abs(o - full).max() > 1e-4


def test_ddgi_frames_do_real_work(ddgi_walk):
    """The probes took light in both frames (frame 1 updates the next 64
    probes of the round-robin and keeps the others as they came in), and
    DDGI's ambient reaches the image: LightingCompose adds to the direct
    light where geometry covers."""
    _, out = ddgi_walk
    irr0 = _np(out[0, "DDGI"][0]["DDGI.irradiance"])
    irr1 = _np(out[1, "DDGI"][0]["DDGI.irradiance"])
    assert irr0[:64].max() > 0.0 and irr0[64:].max() == 0.0
    assert irr1[64:128].max() > 0.0
    assert (irr1[:64] == _np(out[0, "DDGI"][1]["DDGI.irradiance"])[:64]).all()
    for frame in (0, 1):
        lit = _np(out[frame, "LightingCompose"][0]["SceneColor"])
        direct = _np(out[frame, "VisibilityShading"][1]["SceneColor"])
        assert (lit - direct).max() > 1e-3


def test_ddgi_and_showcase_goldens():
    """tests/goldens/ddgi.png and showcase.png (test_golden.py's cases)
    rendered by the port on the CPU, within the golden test's thresholds."""
    import arkoserenderer_torch.assets.procedural as tproc
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.ops.ddgi import ProbeGridConfig
    from arkoserenderer_torch.utils.imageio import load_png, to_u8
    from test_torch_forward import GOLDENS, assert_golden_close

    cfg = TPipelineConfig(width=256, height=256, shadow_map_size=256,
                          raster=TRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256))
    flags = {"ddgi": dict(taa=False, bloom=False),
             "showcase": dict(rt_shadows=True, rt_reflections=True, ssao=True, fog=True,
                              motion_blur=True)}
    for name, kw in flags.items():
        scene, cam = tproc.build_test_scene(viewport=(256, 256), n_spheres=1)
        r = Renderer(scene, cam, cfg, device="cpu", ddgi=ProbeGridConfig(), **kw)
        img = r.render_frames(2)
        assert_golden_close(to_u8(img.numpy()), load_png(str(GOLDENS / f"{name}.png"))[..., :3])


def test_flagship_scene_matches_jax():
    """Equal pools, lights and camera at the bench's small size, and the
    full-size scene's triangle count (786,434)."""
    from arkoserenderer_torch.assets.procedural import build_flagship_scene as t_build
    from arkoserenderer_tpu.assets.procedural import build_flagship_scene as j_build
    from test_torch_scene import assert_field_equal

    kw = dict(n_instances=256, n_materials=64, n_textures=16, viewport=(96, 64))
    js, jc = j_build(**kw)
    ts, tc = t_build(**kw)
    ref = bridge.numpy_fields(js.build())
    ours = bridge.numpy_fields(ts.build("cpu"))
    assert set(ours) <= set(ref)
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    jst, tst = js.static_info(), ts.static_info()
    for f in type(tst).__dataclass_fields__:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.n_spots == 2 and tst.spot_shadow_casters == (True, True)
    assert tst.n_points == 1 and tst.point_shadow_casters == (False,)
    for f in jc.state(0)._fields:
        assert_field_equal(f, getattr(tc.state(0, "cpu"), f), getattr(jc.state(0), f))
    jb, tb = js.bounding_sphere(), ts.bounding_sphere()
    np.testing.assert_array_equal(tb[0], jb[0])
    assert tb[1] == jb[1]
    full, _ = t_build(viewport=(96, 64))
    assert sum(len(full.segments[sid].indices) for sid, *_ in full.instances) == 3 * 786_434


@pytest.mark.parametrize("name", ["showcase", "flagship"])
def test_bench_ddgi_kinds_small(name, monkeypatch):
    """The bench's showcase and flagship kinds at their small size on the
    CPU: the passes in the reference's order, the grid the bench resolves,
    two finite frames with coverage, and the traces of each frame by label
    as expected_trace_launches_by_label counts them (5 and 11 a frame)."""
    import collections

    from arkoserenderer_torch.ops import bvh as bvh_ops
    from arkoserenderer_torch.ops import ddgi, rt
    from arkoserenderer_torch.rendering.passes import rt as rt_passes
    from arkoserenderer_torch.tools import bench

    r = bench.build_renderer(name, small=True, device="cpu")
    names = [p.name for p in r.pipeline.passes]
    assert names[:3] == ["Scene", "Geometry", "DDGI"] and "SunShadow" not in names
    grid = r.pipeline.passes[2].grid
    if name == "flagship":
        assert (grid.dims, grid.rays_per_probe, grid.probes_per_frame) == ((8, 4, 8), 128, 64)
        assert names[3:5] == ["RTShadow", "RTLocalShadow"]
    labels = collections.Counter()

    def by_label(*args, label=None, **kw):
        labels[label] += 1
        return bvh_ops.trace_rays(*args, label=label, **kw)

    for mod in (ddgi, rt, rt_passes):
        monkeypatch.setattr(mod, "trace_rays", by_label)
    for _ in range(2):
        img = r.render_frame()
        assert torch.isfinite(img).all() and r.state["SceneCoverage"].any()
    want = bench.expected_trace_launches_by_label(r, 2)
    assert dict(labels) == want
    assert sum(want.values()) == (5 if name == "showcase" else 11) * 2
