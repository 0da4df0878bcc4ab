"""The port's helmet frame against the JAX package's: the reference bench's
`helmet` kind (a grid of DamagedHelmets over a floor, RT sun shadows and
DDGI) at a small size, and the helmet golden.

* ``build_helmet_scene(n_grid=2, viewport=(96, 96), max_texture_size=64)``:
  every host array equal to the reference's through ``bridge`` (the pools,
  the packed material rows and records, the lights and the two-level BVH),
  the static facts, the camera and the bounding sphere; and the full-size
  scene's triangle count (556,274).
* The helmet frame's pipeline (rt_shadows, an 8x4x8 DDGI grid at 32 rays x
  64 probes) pass by pass over two frames of a moving camera, each torch
  pass fed JAX's input state (test_torch_showcase.walk), with the
  tolerances of test_torch_showcase.py and test_torch_rt.py.
* The 256^2 helmet golden (tests/goldens/helmet.png; the reference's own
  test skips, for it reads the asset from outside the repository) rendered
  by the port under the golden test's thresholds.
* The bench's small `helmet` kind on the CPU: two frames, the camera
  raster only, and three traces a frame by label.
"""

import collections
import copy

import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets.sample_scenes import build_helmet_scene as t_build
from arkoserenderer_tpu.assets.sample_scenes import build_helmet_scene as j_build
from arkoserenderer_tpu.ops import ddgi as jdd
from test_torch_ddgi import _assert_atlas_close
from test_torch_passes import _np, compare
from test_torch_rt import compare_rt
from test_torch_scene import assert_field_equal
from test_torch_showcase import walk

torch.set_num_threads(2)

SMALL = dict(n_grid=2, viewport=(96, 96), max_texture_size=64)
HELMET_PASSES = ["Scene", "Geometry", "DDGI", "RTShadow", "VisibilityShading",
                 "LightingCompose", "SkyView", "Bloom", "TAA", "Output"]


@pytest.fixture(scope="module")
def scenes():
    js, jc = j_build(**SMALL)
    ts, tc = t_build(**SMALL)
    return js, jc, ts, tc


def test_helmet_scene_matches_jax(scenes):
    js, jc, ts, tc = scenes
    ref = bridge.numpy_fields(js.build(with_bvh=True))
    ours = bridge.numpy_fields(ts.build("cpu", with_bvh=True))
    assert set(ours) <= set(ref) and any(k.startswith("bvh.") for k in ours)
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    jst, tst = js.static_info(), ts.static_info()
    for f in type(tst).__dataclass_fields__:
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.uses_emissive_tex and tst.uses_occlusion_tex
    for f in jc.state(0)._fields:
        assert_field_equal(f, getattr(tc.state(0, "cpu"), f), getattr(jc.state(0), f))
    jb, tb = js.bounding_sphere(), ts.bounding_sphere()
    np.testing.assert_array_equal(tb[0], jb[0])
    assert tb[1] == jb[1]
    assert len(ts.instances) == 1 + 4


def test_full_size_helmet_triangles():
    """The bench's 6x6 grid draws 36 helmets of 15,452 triangles and the
    floor's two; the textures are read at a small size here."""
    full, _ = t_build(n_grid=6, viewport=(96, 96), max_texture_size=4)
    assert sum(len(full.segments[sid].indices) for sid, *_ in full.instances) == 3 * 556_274
    assert len(full.instances) == 37


@pytest.fixture(scope="module")
def helmet_walk(scenes):
    js, jc, ts, _ = scenes
    center, radius = js.bounding_sphere()
    grid = jdd.ProbeGridConfig.fit_bounds(center, radius, dims=(8, 4, 8), rays_per_probe=32,
                                          probes_per_frame=64)
    out = walk(js, copy.deepcopy(jc), ts, dict(rt_shadows=True, ddgi=grid))
    assert out["names"] == HELMET_PASSES
    return out


@pytest.mark.parametrize("frame", [0, 1])
def test_helmet_frames_match_jax(helmet_walk, frame):
    """Every published key of every pass: the three DDGI atlases, the RT
    sun mask, and the shaded, composed and post-processed images."""
    out = helmet_walk
    geo_t, geo_j = out[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    seen = set()
    for name in HELMET_PASSES:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            seen.add(key)
            if key in ("DDGI.irradiance", "DDGI.visibility"):
                _assert_atlas_close(key[5:], _np(tupd[key]), _np(jupd[key]))
            elif key == "DDGI.offsets":
                np.testing.assert_allclose(_np(tupd[key]), _np(jupd[key]), atol=1e-6, rtol=0)
            elif not compare_rt(key, tupd[key], jupd[key], vis_agree):
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    assert {"DDGI.irradiance", "DDGI.visibility", "ShadowMask.sun"} <= seen
    assert np.isfinite(_np(out[frame, "Output"][0]["LDR"])).all()


def test_helmet_frames_do_real_work(helmet_walk):
    """The helmets cover the frame, the probes take light, and the sun mask
    has both lit and shadowed pixels."""
    out = helmet_walk
    for frame in (0, 1):
        vis = _np(out[frame, "Geometry"][0]["Visibility"])
        assert (vis >= 0).mean() > 0.15
        irr = _np(out[frame, "DDGI"][0]["DDGI.irradiance"])
        assert irr.max() > 0.0
        mask = _np(out[frame, "RTShadow"][0]["ShadowMask.sun"])[vis >= 0]
        assert 0.0 < mask.mean() < 1.0


def test_helmet_golden():
    """tests/goldens/helmet.png (test_golden.py's helmet case, built by
    ``build_helmet_golden_scene``) rendered by the port on the CPU from the
    in-repo DamagedHelmet, within the golden test's thresholds."""
    from arkoserenderer_torch.assets.sample_scenes import build_helmet_golden_scene
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig
    from arkoserenderer_torch.utils.imageio import load_png, to_u8
    from test_torch_forward import GOLDENS, assert_golden_close

    scene, cam = build_helmet_golden_scene()
    cfg = PipelineConfig(width=256, height=256, shadow_map_size=256,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256))
    img = Renderer(scene, cam, cfg, device="cpu", taa=False, bloom=False).render_frame()
    assert_golden_close(to_u8(img.numpy()), load_png(str(GOLDENS / "helmet.png"))[..., :3])


def test_bench_helmet_kind_small(monkeypatch):
    """The bench's small helmet kind on the CPU (3x3 grid, 128^2 textures,
    256^2, an 8x4x8 grid at 128 rays x 64 probes): the passes in the
    reference's order, two finite covered frames, one camera raster a frame
    (RT shadows: no sun map) and three traces a frame by label, as
    expected_launches_by_shape and expected_trace_launches_by_label count
    them."""
    from arkoserenderer_torch.ops import bvh as bvh_ops
    from arkoserenderer_torch.ops import ddgi, raster, rt
    from arkoserenderer_torch.rendering.passes import rt as rt_passes
    from arkoserenderer_torch.tools import bench

    r = bench.build_renderer("helmet", small=True, device="cpu")
    assert [p.name for p in r.pipeline.passes] == HELMET_PASSES
    grid = r.pipeline.passes[2].grid
    assert (grid.dims, grid.rays_per_probe, grid.probes_per_frame) == ((8, 4, 8), 128, 64)
    assert [img.shape for img, *_ in r.scene.images[4:]] == [(128, 128, 4)] * 5
    labels, shapes = collections.Counter(), collections.Counter()
    plain = raster.rasterize_tiles_plain

    def by_label(*args, label=None, **kw):
        labels[label] += 1
        return bvh_ops.trace_rays(*args, label=label, **kw)

    def by_shape(setup, bins, width, height, cfg, depth_only=False, **kw):
        shapes[height, width, depth_only] += 1
        return plain(setup, bins, width, height, cfg, depth_only=depth_only, **kw)

    for mod in (ddgi, rt, rt_passes):
        monkeypatch.setattr(mod, "trace_rays", by_label)
    monkeypatch.setattr(raster, "rasterize_tiles_plain", by_shape)
    for _ in range(2):
        img = r.render_frame()
        assert torch.isfinite(img).all() and r.state["SceneCoverage"].float().mean() > 0.2
    assert dict(labels) == bench.expected_trace_launches_by_label(r, 2) == {
        "sun mask": 2, "ddgi probe": 2, "ddgi sun": 2}
    assert dict(shapes) == bench.expected_launches_by_shape(r, 2) == {(256, 256, False): 2}
