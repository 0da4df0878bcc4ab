"""The port's SSSS pass and the bench's `ddgi` kind against the JAX package.

* ``SSSSPass`` at 96^2 on the test scene with its sphere's material at
  subsurface = 1 (as ``tests/test_ssss_upscale.py`` makes it): each package
  walks the pipeline to LightingCompose and both SSSS passes take JAX's
  state; SceneColor to atol 1e-5 everywhere, non-subsurface pixels equal to
  the input bit for bit, and the subsurface pixels blurred.
* The `ddgi` kind's pipeline (``test_torch_animation.anim_scene`` with its
  clips: the joint moves and the morph weight changes between the frames;
  the grid ``ProbeGridConfig.fit_bounds`` fits by default, as ``--small``
  does) walked pass by pass at 96^2 over two frames by
  ``test_torch_showcase.walk``: frame 0's persistent state fed to frame 1,
  each torch pass given the JAX input state of that pass. Tolerances are
  test_torch_showcase.py's, plus the Scene pass's skinned and morphed pool
  (geom.positions / normals / tangents) to test_torch_animation.py's atol
  1e-5, and the refitted ``scene.bvh``: quad records and descriptors
  equal, float lanes within test_torch_refit.py's 4 ulps.
* The bench's `ddgi` kind at ``--small`` on the CPU: the passes in the
  reference's order, two finite, covered frames, the rasters by shape as
  ``expected_launches_by_shape`` counts them (the sun map every frame) and
  the traces by label as ``expected_trace_launches_by_label`` (ddgi probe
  and ddgi sun a frame).
"""

import collections

import numpy as np
import pytest
import torch

from arkoserenderer_tpu.ops import ddgi as jdd
from test_torch_animation import anim_scene
from test_torch_ddgi import _assert_atlas_close
from test_torch_passes import RES, _np, compare
from test_torch_refit import ULPS, _ulps
from test_torch_rt import compare_rt
from test_torch_showcase import DDGI_KEYS, walk

torch.set_num_threads(2)

DDGI_PASSES = ["Scene", "Geometry", "BVHRefit", "DDGI", "SunShadow", "VisibilityShading",
               "LightingCompose", "SSSS", "SkyView", "Bloom", "TAA", "Output"]
SSSS_PASSES = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose", "SSSS",
               "SkyView", "Output"]
DEFORMED = ("geom.positions", "geom.normals", "geom.tangents")


# -- SSSS on a subsurface material -------------------------------------------------


@pytest.fixture(scope="module")
def ssss_walk():
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_tpu.assets.procedural as jproc

    jscene, jcam = jproc.build_test_scene(viewport=(RES, RES), n_spheres=1)
    tscene, _ = tproc.build_test_scene(viewport=(RES, RES), n_spheres=1)
    for s in (jscene, tscene):
        s.materials[2].subsurface = 1.0  # the sphere becomes skin
    return walk(jscene, jcam, tscene, dict(ssss=True, taa=False, bloom=False), frames=1)


def test_ssss_matches_jax_on_subsurface(ssss_walk):
    assert ssss_walk["names"] == SSSS_PASSES
    tupd, jupd = ssss_walk[0, "SSSS"]
    before = _np(ssss_walk[0, "LightingCompose"][1]["SceneColor"])
    ours, ref = _np(tupd["SceneColor"]), _np(jupd["SceneColor"])
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    skin = _np(ssss_walk[0, "VisibilityShading"][1]["SceneMaterial"])[..., 3] > 0.5
    assert skin.sum() > 50  # the sphere covers 1.3 % of the frame
    np.testing.assert_array_equal(ours[~skin], before[~skin])
    change = np.abs(ours - before).max(-1)
    assert change[skin].mean() > 1e-3 and (change[skin] > 1e-4).mean() > 0.5


# -- the ddgi kind's pipeline over two frames ---------------------------------------


@pytest.fixture(scope="module")
def ddgi_walk():
    jscene, jcam = anim_scene("jax", viewport=(RES, RES), moving=True)
    tscene, _ = anim_scene("torch", viewport=(RES, RES), moving=True)
    center, radius = jscene.bounding_sphere()
    grid = jdd.ProbeGridConfig.fit_bounds(center, radius)
    return walk(jscene, jcam, tscene, dict(ddgi=grid, ssss=True, rt_refit=True), frames=2,
                animate=True)


def _compare_bvh(ours, ref):
    np.testing.assert_array_equal(ours.quad_rec.numpy(), np.asarray(ref.quad_rec))
    for f, n_float in (("wide_rec", 48), ("inst_rec", 12)):
        o, r = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(o[:, n_float:], r[:, n_float:], err_msg=f)
        assert _ulps(o[:, :n_float].view(np.float32), r[:, :n_float].view(np.float32)) <= ULPS
    assert ours.n_tlas == ref.n_tlas


@pytest.mark.parametrize("frame", [0, 1])
def test_ddgi_kind_frames_match_jax(ddgi_walk, frame):
    """Every published key of every pass, the refitted BVH and the three
    DDGI atlases included."""
    out = ddgi_walk
    assert out["names"] == DDGI_PASSES
    vis_agree = _np(out[frame, "Geometry"][0]["Visibility"]) == _np(
        out[frame, "Geometry"][1]["Visibility"])
    seen = set()
    for name in DDGI_PASSES:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            seen.add(key)
            if key == "scene.bvh":
                _compare_bvh(tupd[key], jupd[key])
            elif key in DEFORMED:
                np.testing.assert_allclose(_np(tupd[key]), _np(jupd[key]), atol=1e-5, rtol=0,
                                           err_msg=key)
            elif key in ("DDGI.irradiance", "DDGI.visibility"):
                _assert_atlas_close(key[5:], _np(tupd[key]), _np(jupd[key]))
            elif key == "DDGI.offsets":
                np.testing.assert_allclose(_np(tupd[key]), _np(jupd[key]), atol=1e-6, rtol=0)
            elif not compare_rt(key, tupd[key], jupd[key], vis_agree):
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    assert set(DDGI_KEYS) | {"scene.bvh", "ShadowMap.sun"} <= seen
    assert np.isfinite(_np(out[frame, "Output"][0]["LDR"])).all()


def test_ddgi_kind_follows_the_animation(ddgi_walk):
    """Between the frames the skinned box and the morphed sphere move in the
    Scene pass's pool, the refitted BVH and the per-frame sun map; the
    probes take light in both frames."""
    out = ddgi_walk
    pos = [_np(out[f, "Scene"][0]["geom.positions"]) for f in (0, 1)]
    assert np.abs(pos[1] - pos[0]).max() > 0.05
    quads = [out[f, "BVHRefit"][0]["scene.bvh"].quad_rec for f in (0, 1)]
    assert not torch.equal(*quads)
    suns = [_np(out[f, "SunShadow"][0]["ShadowMap.sun"]) for f in (0, 1)]
    assert np.abs(suns[1] - suns[0]).max() > 0.0
    for f in (0, 1):
        assert _np(out[f, "DDGI"][0]["DDGI.irradiance"]).max() > 0.0


# -- the bench's ddgi kind at its small size -------------------------------------------


def test_bench_ddgi_kind_small(monkeypatch):
    from arkoserenderer_torch.ops import bvh as bvh_ops
    from arkoserenderer_torch.ops import ddgi, raster
    from arkoserenderer_torch.tools import bench

    r = bench.build_renderer("ddgi", small=True, device="cpu")
    assert [p.name for p in r.pipeline.passes] == DDGI_PASSES
    grid = r.pipeline.passes[3].grid
    assert (grid.dims, grid.rays_per_probe, grid.probes_per_frame) == ((8, 4, 8), 128, 64)
    labels, shapes = collections.Counter(), collections.Counter()
    plain = raster.rasterize_tiles_plain

    def by_label(*args, label=None, **kw):
        labels[label] += 1
        return bvh_ops.trace_rays(*args, label=label, **kw)

    def by_shape(setup, bins, width, height, cfg, depth_only=False, **kw):
        shapes[height, width, depth_only] += 1
        return plain(setup, bins, width, height, cfg, depth_only=depth_only, **kw)

    monkeypatch.setattr(ddgi, "trace_rays", by_label)
    monkeypatch.setattr(raster, "rasterize_tiles_plain", by_shape)
    for _ in range(2):
        img = r.render_frame()
        assert torch.isfinite(img).all() and r.state["SceneCoverage"].any()
    assert dict(labels) == bench.expected_trace_launches_by_label(r, 2) == {
        "ddgi probe": 2, "ddgi sun": 2}
    assert dict(shapes) == bench.expected_launches_by_shape(r, 2) == {
        (256, 256, False): 2, (256, 256, True): 2}
    assert r.time == pytest.approx(2 / 60)
