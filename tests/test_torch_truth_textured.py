"""The twin of tests/test_truth.py::test_textured_block_means, against the
JAX package. The reference's own textured test fails (fault R1: its
raster's packed mips average sRGB values, the tracer's pool averages
linear ones; block-mean rel 0.0353 against its 0.03). The port follows the
reference there, so this twin holds the port's 8x8 block means to JAX's
within 1e-3 relative on both sides, the raster frame and the 8-sample
trace (the textured test scene, sun only, at 64^2: the JAX side's
compiles and samples at 128^2 took most of a minute beside the other
tests), and the reference's
metric on the port's pair to the reference's pair: R1 shows in both and is
hidden in neither.
"""

import numpy as np
import pytest
import torch

from arkoserenderer_torch.assets.procedural import build_test_scene
from test_torch_truth import _sun_only, truth_pair

torch.set_num_threads(2)

RES = 64


def block_means(img: np.ndarray) -> np.ndarray:
    return img.reshape(RES // 8, 8, RES // 8, 8, 3).mean((1, 3))


def block_rel(raster: np.ndarray, pt: np.ndarray) -> np.ndarray:
    """The reference's textured metric over 8x8 block means."""
    rb, pb = block_means(raster), block_means(pt)
    return np.abs(pb - rb).max(-1) / (rb.mean(-1) + 0.02)


@pytest.fixture(scope="module")
def textured_pairs():
    """(port pair, JAX pair) of the textured test scene, sun only: the
    raster frame and 8 jittered samples (seed 5), as test_truth.py."""
    from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build
    from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
    from arkoserenderer_tpu.models.pathtracer import PathTracer as JPathTracer
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

    def make():
        scene, cam = build_test_scene(viewport=(RES, RES))
        _sun_only(scene)
        return scene, cam

    ours = truth_pair(make, seed=5, samples=8, aa=True, res=RES)
    jcfg = JPipelineConfig(width=RES, height=RES,
                           raster=JRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                           shadow_map_size=512)
    js, jc = j_build(viewport=(RES, RES))
    _sun_only(js)
    j_raster = np.array(JRenderer(js, jc, jcfg, rt_shadows=True, taa=False, bloom=False,
                                  vignette=0.0).render_frame())
    js2, jc2 = j_build(viewport=(RES, RES))
    _sun_only(js2)
    jt = JPathTracer(js2, jc2, RES, RES, max_bounces=1, seed=5)
    jt.render_sample(8)
    return ours, (j_raster, np.array(jt.ldr()))


@pytest.mark.parametrize("side", ["raster", "pathtraced"])
def test_textured_block_means_parity(textured_pairs, side):
    (o_r, o_p), (j_r, j_p) = textured_pairs
    i = 0 if side == "raster" else 1
    ours, ref = block_means((o_r, o_p)[i]), block_means((j_r, j_p)[i])
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-3)
    assert rel.max() < 1e-3, f"{side}: block means off by {rel.max():.2e} relative"


def test_textured_block_metric_follows_reference(textured_pairs):
    """The reference's textured metric, on the port's pair and on JAX's,
    agrees: whatever R1 makes of the reference, it makes of the port."""
    (o_r, o_p), (j_r, j_p) = textured_pairs
    ours, ref = block_rel(o_r, o_p), block_rel(j_r, j_p)
    assert abs(ours.mean() - ref.mean()) < 1e-3, (ours.mean(), ref.mean())
    assert abs((ours > 0.10).mean() - (ref > 0.10).mean()) <= 1.0 / ours.size
