"""The port's reference shading mode (``shading_mode="reference"``) in
whole frames at 128^2 through both Renderers, the forward and test_spot
scenes of test_torch_reference_shading.py, and the forward scene under
``texture_quality="sorted"`` (the nearest mip through the sorted tile
gather, ``ops/texture.sample_bilinear_sorted``), held to
test_torch_forward.py's bounds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_passes import RASTER
from test_torch_reference_shading import SIZES, build

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["forward", "test_spot", "forward_sorted"])
def test_reference_mode_frame_matches_jax_renderer(case):
    """Whole frames at 128^2 (no TAA, no Bloom) through both Renderers:
    the LDR images to test_torch_forward.py's bound (2e-4 on all but 0.2 %
    of values, means within 1e-5)."""
    from arkoserenderer_torch.models.standard import Renderer as TRenderer
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer

    res = 128
    kind = "spot" if case == "test_spot" else "test"
    sizes = dict(SIZES, width=res, height=res, shading_mode="reference")
    if case == "forward_sorted":
        sizes["texture_quality"] = "sorted"
    jr = JRenderer(*build(kind, "jax", res),
                   JPipelineConfig(raster=JRasterConfig(**RASTER), **sizes),
                   taa=False, bloom=False)
    tr = TRenderer(*build(kind, "torch", res),
                   TPipelineConfig(raster=TRasterConfig(**RASTER), **sizes),
                   device="cpu", taa=False, bloom=False)
    ref = np.array(jr.render_frame())
    ours = tr.render_frame().numpy()
    assert tr.cfg.shading_mode == "reference" and np.isfinite(ours).all()
    assert tr.cfg.texture_quality == jr.cfg.texture_quality
    diff = np.abs(ours - ref)
    assert (diff > 2e-4).mean() < 0.002, (diff > 2e-4).mean()
    assert abs(ours.mean() - ref.mean()) < 1e-5


def test_reference_mode_sorted_quality_raises_by_name():
    """"sorted" under the reference mode was refused until the tile gather
    was ported: PipelineConfig now takes it as the reference's does, in
    both modes (the packed mode keeps it as trilinear), and raises on an
    unknown filter only."""
    for mode in ("reference", "packed"):
        ours = TPipelineConfig(shading_mode=mode, texture_quality="sorted")
        ref = JPipelineConfig(shading_mode=mode, texture_quality="sorted")
        assert (ours.shading_mode, ours.texture_quality) == (ref.shading_mode,
                                                             ref.texture_quality)
    cfg = dataclasses.replace(TPipelineConfig(shading_mode="reference"), texture_quality="sorted")
    assert cfg.texture_quality == "sorted"
    with pytest.raises(ValueError, match="texture_quality"):
        TPipelineConfig(shading_mode="reference", texture_quality="no_such_filter")
