"""The port's output extras against the JAX package's: the .cube colour
grade, the PQ encode and auto-exposure.

* ``assets/external.CubeLUT`` and ``apply_lut3d``: the twins of
  ``tests/test_aux.py``'s identity round trip (atol 1e-5) and parse cases,
  the same parse of a text with a domain and comments as the reference's,
  and ``apply_lut3d`` on a random 5^3 table within 1e-6 of JAX's;
* ``OutputPass(color_grade_lut=)`` in a 96^2 frame of the port's Renderer,
  the twin of ``test_aux.py::test_color_grade_lut_in_output``: a LUT that
  zeroes blue leaves no blue, and the graded LDR equals the ungraded one
  run through ``apply_lut3d`` within 1e-6;
* ``ops/tonemap.encode_st2084`` against JAX's over 0-12,000 nits (rtol
  1e-5, atol 1e-6; a power of a power) and its endpoints, the twin of
  ``tests/test_tonemap.py::test_st2084_endpoints``;
* ``Renderer(auto_exposure=True)`` at 64^2: ``camera.exposure_compensation``
  after each of 4 frames within 1e-5 of the JAX Renderer's, and moving.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.assets.external import CubeLUT, apply_lut3d
from arkoserenderer_torch.ops import tonemap as ttm
from arkoserenderer_tpu.assets import external as jext
from arkoserenderer_tpu.ops import tonemap as jtm

torch.set_num_threads(2)

CUBE_TEXT = """# comment
TITLE "test"
LUT_3D_SIZE 2
0 0 0
1 0 0
0 1 0
1 1 0
0 0 1
1 0 1
0 1 1
1 1 1
"""


def test_cube_lut_identity_roundtrip(rng):
    lut = CubeLUT.identity(8)
    c = rng.random((64, 3)).astype(np.float32)
    out = apply_lut3d(torch.from_numpy(lut.table), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(out, c, atol=1e-5)
    np.testing.assert_array_equal(lut.table, jext.CubeLUT.identity(8).table)


def test_cube_lut_parse():
    lut = CubeLUT.parse(CUBE_TEXT)
    assert lut.size == 2
    np.testing.assert_allclose(lut.table[0, 0, 1], [1, 0, 0])  # r fastest
    text = "DOMAIN_MIN 0 0 0\nDOMAIN_MAX 2 2 2\nLUT_1D_SIZE 4\n" + CUBE_TEXT
    ours, ref = CubeLUT.parse(text), jext.CubeLUT.parse(text)
    for f in ("size", "table", "domain_min", "domain_max"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    with pytest.raises(ValueError, match="malformed"):
        CubeLUT.parse("LUT_3D_SIZE 2\n0 0 0\n")


def test_apply_lut3d_matches_jax():
    rng = np.random.default_rng(11)
    table = rng.random((5, 5, 5, 3)).astype(np.float32)
    c = rng.uniform(-0.2, 1.2, (32, 16, 3)).astype(np.float32)
    ours = apply_lut3d(torch.from_numpy(table), torch.from_numpy(c)).numpy()
    ref = np.asarray(jext.apply_lut3d(table, jnp.asarray(c)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_color_grade_lut_in_output():
    from arkoserenderer_torch.assets.procedural import build_test_scene
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.rendering.passes.output import OutputPass
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig

    lut = CubeLUT.identity(4)
    lut.table[..., 2] = 0.0
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    cfg = PipelineConfig(width=96, height=96,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                         shadow_map_size=128)
    r = Renderer(scene, cam, cfg, device="cpu", taa=False, bloom=False)
    plain = r.render_frame().clone()
    r.frame_index, r.camera = 0, build_test_scene(viewport=(96, 96), n_spheres=1)[1]
    for i, p in enumerate(r.pipeline.passes):
        if isinstance(p, OutputPass):
            r.pipeline.passes[i] = OutputPass(color_grade_lut=lut)
    r.pipeline.construct_all()
    img = r.render_frame().numpy()
    assert img[..., 2].max() < 1e-5
    assert img[..., 0].max() > 0.05
    graded = apply_lut3d(torch.from_numpy(lut.table), plain).numpy()
    np.testing.assert_allclose(img, graded, atol=1e-6, rtol=0)


def test_encode_st2084_matches_jax():
    nits = np.concatenate([np.geomspace(1e-4, 12000.0, 500), [0.0, -5.0]]).astype(np.float32)
    ours = ttm.encode_st2084(torch.from_numpy(nits)).numpy()
    ref = np.asarray(jtm.encode_st2084(jnp.asarray(nits)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_st2084_endpoints():
    def pq(v):
        return ttm.encode_st2084(torch.tensor([v])).numpy()

    np.testing.assert_allclose(pq(0.0), [0.0], atol=1e-6)
    np.testing.assert_allclose(pq(10000.0), [1.0], atol=1e-5)
    np.testing.assert_allclose(pq(100.0), [0.508], atol=5e-3)


def test_auto_exposure_matches_jax():
    from arkoserenderer_torch.assets.procedural import build_test_scene as t_build
    from arkoserenderer_torch.core.types import RasterConfig as TRaster
    from arkoserenderer_torch.models.standard import Renderer as TRenderer
    from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TCfg
    from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build
    from arkoserenderer_tpu.core.types import RasterConfig as JRaster
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JCfg

    raster = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
    sizes = dict(width=64, height=64, shadow_map_size=128)
    ts, tc = t_build(viewport=(64, 64), n_spheres=1)
    js, jc = j_build(viewport=(64, 64), n_spheres=1)
    assert tc.adaption_rate == jc.adaption_rate
    ours = TRenderer(ts, tc, TCfg(raster=TRaster(**raster), **sizes), device="cpu",
                     auto_exposure=True, bloom=False)
    ref = JRenderer(js, jc, JCfg(raster=JRaster(**raster), **sizes), auto_exposure=True,
                    bloom=False)
    seen = []
    for _ in range(4):
        ours.render_frame()
        ref.render_frame()
        assert abs(tc.exposure_compensation - jc.exposure_compensation) < 1e-5
        seen.append(tc.exposure_compensation)
    assert abs(seen[-1]) > 1e-3 and seen[0] != seen[-1]
