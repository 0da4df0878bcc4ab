"""The port's reference shading mode (``shading_mode="reference"``) in
whole frames at 128^2 through both Renderers, the forward and test_spot
scenes of test_torch_reference_shading.py, held to test_torch_forward.py's
bounds; and the configuration this mode does not take
(``texture_quality="sorted"``) raising by name.
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


@pytest.mark.parametrize("case", ["forward", "test_spot"])
def test_reference_mode_frame_matches_jax_renderer(case):
    """Whole frames at 128^2 (no TAA, no Bloom) through both Renderers:
    the LDR images to test_torch_forward.py's bound (2e-4 on all but 0.2 %
    of values, means within 1e-5)."""
    from arkoserenderer_torch.models.standard import Renderer as TRenderer
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer

    res = 128
    kind = "spot" if case == "test_spot" else "test"
    sizes = dict(SIZES, width=res, height=res, shading_mode="reference")
    jr = JRenderer(*build(kind, "jax", res),
                   JPipelineConfig(raster=JRasterConfig(**RASTER), **sizes),
                   taa=False, bloom=False)
    tr = TRenderer(*build(kind, "torch", res),
                   TPipelineConfig(raster=TRasterConfig(**RASTER), **sizes),
                   device="cpu", taa=False, bloom=False)
    ref = np.array(jr.render_frame())
    ours = tr.render_frame().numpy()
    assert tr.cfg.shading_mode == "reference" and np.isfinite(ours).all()
    diff = np.abs(ours - ref)
    assert (diff > 2e-4).mean() < 0.002, (diff > 2e-4).mean()
    assert abs(ours.mean() - ref.mean()) < 1e-5


def test_reference_mode_sorted_quality_raises_by_name():
    """The reference mode's one-hot tile gather ("sorted") is not ported:
    PipelineConfig raises naming the field; the packed mode takes "sorted"
    as trilinear."""
    with pytest.raises(NotImplementedError, match="texture_quality"):
        TPipelineConfig(shading_mode="reference", texture_quality="sorted")
    cfg = TPipelineConfig(shading_mode="reference")
    with pytest.raises(NotImplementedError, match="sorted"):
        dataclasses.replace(cfg, texture_quality="sorted")
    assert TPipelineConfig(texture_quality="sorted").shading_mode == "packed"
