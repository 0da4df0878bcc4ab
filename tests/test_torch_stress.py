"""The port's stress frame against the JAX package's: the culling-stress
scene (LOD chains, 64 grid cells here), its host and in-frame animation,
the instance-transform upload, and every pass of the animated frame.

Sizes: ``build_stress_scene(n_instances=64)`` at 128^2, tile 8x16, K = 256,
a 256^2 sun map; at this size neither side's bins overflow.

Tolerances:
  * host scene arrays and the host transform update: the same numpy code on
    both sides, so ints equal and floats to 1e-6 (in practice equal);
  * the animator's rows: 1e-6. Both form t = frame * dt in float32; torch's
    and XLA's sin and cos differ by an ulp or two (values up to 8, so an ulp
    of a translation is 5e-7);
  * the pass walk: the rules of tests/test_torch_passes.py (``compare``),
    each pass fed the JAX input state, so nothing compounds, with one
    addition: the floats of the raster setup and the shading records are
    compared on the rows the raster takes (``setup.valid``, itself equal).
    A culled row, such as a triangle wholly behind the near plane, keeps
    values no pass reads: its clipped w lands near 0, and 1/w turns an ulp
    of the clip into hundreds of pixels. Visibility is held exactly where
    its inputs are identical: the port's raster on the JAX setup and bins
    gives the JAX ids bit for bit (and the depths to 1e-6). VisibilityShading's
    SceneColor is held by a share of values and a cap (FLIPS): the metallic
    spheres' highlights reach 13 in pre-exposed HDR, where the GGX lobe
    turns an ulp of the normal into a few 1e-4, and the floor's VSM shadow
    edges are as sensitive;
  * the animator path against the host ``dynamic_transforms`` path inside
    the port: the thresholds of tests/test_stress.py:147-150 (mean abs diff
    < 1e-3, under 0.5 % of pixels off by more than 0.05). The two paths
    form t in float32 and in double, so a transform can differ by an ulp
    and a pixel on a triangle edge can change its triangle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets import procedural as tproc
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.ops import raster as traster
from arkoserenderer_torch.rendering.passes.geometry import lod_instance_mask as t_lod_mask
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.assets import procedural as jproc
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.ops import raster as jraster
from arkoserenderer_tpu.rendering.passes.geometry import lod_instance_mask as j_lod_mask
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_passes import _np, _torch_state, compare, compare_flips
from test_torch_scene import assert_field_equal

torch.set_num_threads(2)

RES, N_INST, DT = 128, 64, 1 / 60
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
FORWARD = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
           "SkyView", "Bloom", "TAA", "Output"]
INSTANCE_ROWS = ("world", "prev_world", "normal_mat", "inst_sphere", "inst_lod_band")
ANIMATED_ROWS = ("world", "prev_world", "normal_mat", "inst_sphere")
# (pass, resource) -> (bound, share of values allowed over it, cap on those)
FLIPS = {("VisibilityShading", "SceneColor"): (2e-4, 0.001, 1e-3)}


def both_stress(meshlets=False):
    js, jc = jproc.build_stress_scene(n_instances=N_INST, viewport=(RES, RES))
    ts, tc = tproc.build_stress_scene(n_instances=N_INST, viewport=(RES, RES))
    js.enable_meshlets = ts.enable_meshlets = meshlets
    return js, jc, ts, tc


def test_stress_scene_arrays_match_jax():
    """Every pool, prev_world and the LOD bands included, and the scene's
    static facts; floor + 64 cells x 2 LOD levels."""
    js, jc, ts, tc = both_stress()
    ref = bridge.numpy_fields(js.build())
    ours = bridge.numpy_fields(ts.build("cpu"))
    assert set(ours) <= set(ref) and {"prev_world", "inst_lod_band"} <= set(ours)
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    assert int(ours["inst_valid"].sum()) == 1 + 2 * N_INST
    bands = ours["inst_lod_band"][1:1 + 2 * N_INST]
    np.testing.assert_array_equal(bands[0::2, 1], bands[1::2, 0])  # the switch: 14 units
    assert bands[0, 1] == 14.0
    jst, tst = js.static_info(), ts.static_info()
    for f in type(tst).__dataclass_fields__:
        assert getattr(tst, f) == getattr(jst, f), f
    for f in jc.state(0)._fields:
        assert_field_equal(f, getattr(tc.state(0, "cpu"), f), getattr(jc.state(0), f))


@pytest.mark.parametrize("cam_pos", [(1.28, 4.0, 1.92), (14.0, 4.0, 12.0), (30.0, 6.0, -25.0)])
def test_lod_selection_matches_jax(cam_pos):
    """The LOD band mask for camera positions near, across and beyond the
    14-unit switch: equal, and exactly one level of each cell drawn."""
    js, _, ts, _ = both_stress()
    jsa, tsa = js.build(), ts.build("cpu")
    pos = np.array(cam_pos, np.float32)
    ours = t_lod_mask(tsa, torch.from_numpy(pos)).numpy()
    ref = np.asarray(j_lod_mask(jsa, jnp.asarray(pos)))
    np.testing.assert_array_equal(ours, ref)
    cells = ours[1:1 + 2 * N_INST].reshape(N_INST, 2)
    assert (cells.sum(1) == 1).all()
    if cam_pos[0] == 14.0:
        assert cells[:, 0].any() and cells[:, 1].any()  # both levels in one frame


@pytest.mark.parametrize("times", [(0.0, 0.35, 0.7)])
def test_host_animation_and_transform_upload_match_jax(times):
    """animate_stress_scene, then update_instance_transforms, at three
    times: the instance rows equal JAX's; the previous transform is the
    one before; nothing else of the arrays changes."""
    js, _, ts, _ = both_stress()
    jsa, tsa = js.build(), ts.build("cpu")
    for t in times:
        jproc.animate_stress_scene(js, t)
        tproc.animate_stress_scene(ts, t)
        before = tsa
        jsa = js.update_instance_transforms(jsa)
        tsa = ts.update_instance_transforms(tsa)
        for name in INSTANCE_ROWS:
            assert_field_equal(name, getattr(tsa, name).numpy(), np.asarray(getattr(jsa, name)))
        assert tsa.positions is before.positions and tsa.indices is before.indices
    np.testing.assert_array_equal(tsa.prev_world[1:3].numpy(), np.asarray(jsa.prev_world[1:3]))
    assert not np.array_equal(tsa.world[1].numpy(), tsa.prev_world[1].numpy())


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_animator_rows_match_jax(frame):
    """make_stress_animator at frames 0-2: the four animated pools within
    1e-6 of JAX's, the untouched rows equal, and the caller's arrays left
    as built (the animator writes copies)."""
    js, _, ts, _ = both_stress()
    jsa, tsa = js.build(), ts.build("cpu")
    keep = {k: getattr(tsa, k).clone() for k in ANIMATED_ROWS}
    ja = jproc.make_stress_animator(js)(jsa, jnp.asarray(frame, jnp.int32),
                                        jnp.asarray(DT, jnp.float32))
    ta = tproc.make_stress_animator(ts)(tsa, frame, DT)
    for name in ANIMATED_ROWS:
        assert_field_equal(name, getattr(ta, name).numpy(), np.asarray(getattr(ja, name)))
        assert torch.equal(getattr(tsa, name), keep[name]), name
    assert torch.equal(ta.world[0], tsa.world[0])  # the floor does not move
    assert (ta.world[1:] != ta.prev_world[1:]).any()


def walk_animated(meshlets: bool, frames=(0, 1)):
    """Both forward pipelines of the animated stress scene, pass by pass,
    over ``frames`` (still camera; the JAX animator's scene fed to both, the
    persistent state carried as the Renderer carries it):
    {(frame, pass): (torch, jax) updates}."""
    js, jc, ts, _ = both_stress(meshlets)
    sizes = dict(width=RES, height=RES, shadow_map_size=256)
    jst =dataclasses.replace(js.static_info(), dynamic=True)
    tst = dataclasses.replace(ts.static_info(), dynamic=True)
    jpipe = j_make_pipeline(JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jst, **sizes))
    tpipe = t_make_pipeline(TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tst, **sizes),
                            device="cpu")
    assert [n for n, _ in jpipe._executes] == FORWARD == [n for n, _ in tpipe._executes]
    persistent = sorted(jpipe.registry.persistent_names)
    assert persistent == sorted(tpipe.registry.persistent_names) == ["TAAHistory"]

    jsa = js.build()
    animate = jproc.make_stress_animator(js)
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes]
    state = jpipe.initial_state()
    out = {}
    for frame in frames:
        if frame:
            jc.post_render()
            state = {k: state[k] for k in persistent}
        jscene = animate(jsa, jnp.asarray(frame, jnp.int32), jnp.asarray(DT, jnp.float32))
        jcs = jc.state(frame)
        tctx = TFrameContext(scene=bridge.scene_arrays_from_numpy(jscene._asdict(), "cpu"),
                             camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                             frame_index=frame, delta_time=DT)
        jctx = JFrameContext(scene=jscene, camera=jcs, frame_index=jnp.asarray(frame, jnp.int32),
                             delta_time=jnp.asarray(DT, jnp.float32),
                             row_offset=jnp.zeros((), jnp.int32))
        for (name, _), jexec, (_, texec) in zip(jpipe._executes, jitted, tpipe._executes):
            tupd = texec(_torch_state(state), tctx)
            jupd = jexec(state, jctx)
            out[frame, name] = (tupd, jupd)
            state = {**state, **jupd}
    return out


def taken_rows(ours_setup, ref_setup, flips: int = 0):
    """The setup rows both rasters take; at most ``flips`` rows may be
    taken by one side only (a triangle whose screen area or bounding box
    sits within an ulp of a cull test)."""
    a, b = _np(ours_setup.valid), _np(ref_setup.valid)
    assert (a != b).sum() <= flips, int((a != b).sum())
    return a & b


def compare_taken_rows(key, ours, ref, valid):
    """The setup's or the records' floats on the rows ``valid`` marks;
    every int on all rows and the flags on those rows."""
    pairs = zip(ours, ref) if key == "vis.setup" else [(ours, ref)]
    for o, r in pairs:
        o, r = _np(o), _np(r)
        if o.dtype == bool and o.shape[:1] == valid.shape:
            np.testing.assert_array_equal(o[valid], r[valid], err_msg=key)
        elif np.issubdtype(r.dtype, np.floating) and o.shape[:1] == valid.shape:
            np.testing.assert_allclose(o[valid], r[valid], rtol=1e-5, atol=1e-5, err_msg=key)
        elif np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(o, r, err_msg=key)


def assert_walk_matches(out, frame):
    geo_t, geo_j = out[frame, "Geometry"]
    assert int(_np(geo_j["vis.overflow"])) == 0 == int(_np(geo_t["vis.overflow"]))
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    valid = taken_rows(geo_t["vis.setup"], geo_j["vis.setup"])
    for name in FORWARD:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            if key in ("vis.setup", "vis.records"):
                compare_taken_rows(key, tupd[key], jupd[key], valid)
            elif (name, key) in FLIPS:
                compare_flips(key, tupd[key], jupd[key], *FLIPS[name, key])
            else:
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    assert np.isfinite(_np(out[frame, "Output"][0]["LDR"])).all()


def assert_visibility_exact(out, frame):
    """The port's raster on the JAX setup and bins gives the JAX
    Visibility bit for bit, and its SceneDepth to 1e-6 (the plain raster's
    depth interpolation rounds like eager torch, XLA may fuse it)."""
    _, geo_j = out[frame, "Geometry"]
    jsetup = geo_j["vis.setup"]
    jcfg = JRasterConfig(**RASTER)
    jbins = jraster.bin_triangles(jsetup, RES, RES, jcfg)
    tsetup = bridge.frame_state_from_numpy({"s": jsetup}, "cpu")["s"]
    tbins = traster.TileBins(*(torch.from_numpy(np.array(x)) for x in jbins))
    vis, depth = traster.rasterize_tiles(tsetup, tbins, RES, RES, TRasterConfig(**RASTER))
    np.testing.assert_array_equal(vis.numpy(), _np(geo_j["Visibility"]))
    np.testing.assert_allclose(depth.numpy(), _np(geo_j["SceneDepth"]), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def stress_walk():
    return walk_animated(meshlets=False)


@pytest.mark.parametrize("frame", [0, 1])
def test_stress_frame_matches_jax(stress_walk, frame):
    """Every published key of every pass of the animated stress frame."""
    assert_walk_matches(stress_walk, frame)
    assert_visibility_exact(stress_walk, frame)


def test_stress_frame_is_dynamic(stress_walk):
    """The animation shows: the records carry previous positions, the
    motion vectors come from them with a still camera, and the sun map is
    rastered anew each frame (it changes between the frames)."""
    out = stress_walk
    recs = [out[f, "Geometry"][0]["vis.records"] for f in (0, 1)]
    assert recs[0].shape[1] == 80  # 9 + 3 corners x 14 lanes (prev included) + 32 -> 80
    vel = _np(out[1, "VisibilityShading"][0]["SceneVelocity"])
    assert np.abs(vel).max() > 0.1
    sun0, sun1 = (_np(out[f, "SunShadow"][0]["ShadowMap.sun"]) for f in (0, 1))
    assert not np.array_equal(sun0, sun1)
    assert set(out[1, "SunShadow"][0]) == {"ShadowMap.sun", "ShadowMoments.sun"}


def test_animator_matches_host_transforms_in_port():
    """The animator path and the host dynamic_transforms path render the
    same frame 2, but for triangle-edge pixels (see the module docstring)."""
    from arkoserenderer_torch.tools import bench

    img_d, img_h = bench.animation_paths("cpu")
    assert np.isfinite(img_d.numpy()).all()
    diff = (img_d - img_h).abs()
    assert diff.mean() < 1e-3, float(diff.mean())
    assert (diff.amax(dim=-1) > 0.05).float().mean() < 0.005


@pytest.mark.parametrize("name", ["stress", "meshlet", "forward_upscaled"])
def test_bench_new_kinds_render_on_cpu(name):
    """The bench's new frame kinds, built as the bench builds them at 96^2
    (256 stress cells), over two frames: finite display images, coverage,
    raster launches as the configuration implies them (the sun every frame
    when the scene moves, else once), and a history that moves."""
    from arkoserenderer_torch.tools import bench

    cfg = TPipelineConfig(width=96, height=96, raster=TRasterConfig(**RASTER),
                          shadow_map_size=128)
    r = bench.build_renderer(name, small=True, device="cpu", cfg=cfg)
    calls = []
    real = traster.rasterize_tiles

    def counting(setup, bins, w, h, rcfg, depth_only=False, **kw):
        calls.append((h, w, depth_only))
        return real(setup, bins, w, h, rcfg, depth_only=depth_only, **kw)

    traster.rasterize_tiles = counting
    history = "UpscaleHistory" if name == "forward_upscaled" else "TAAHistory"
    try:
        img = r.render_frame()
        before = r.state[history].clone()
        img = r.render_frame()
    finally:
        traster.rasterize_tiles = real
    want = bench.expected_launches_by_shape(r, 2)
    assert {k: calls.count(k) for k in set(calls)} == want
    assert img.shape == (96, 96, 3) and np.isfinite(img.numpy()).all()
    assert r.state["SceneCoverage"].float().mean() > 0.3
    assert (r.state[history] - before).abs().max() > 1e-3
    counts = bench.frame_counts(r)
    assert 0 < counts["visible_tris"] <= int(r.scene_arrays.tri_valid.sum())
    if name != "forward_upscaled":  # the grid reaches beyond the frustum
        assert counts["visible_tris"] < int(r.scene_arrays.tri_valid.sum())
    assert (counts["meshlets_kept"] is not None) == (name == "meshlet")
