"""Whole translucent frames, the port against the JAX package: the two
scenes of tests/test_translucent.py (one pane, and two panes along one
camera ray) at 96^2 with 1 and 4 layers, through both Renderers.
(test_torch_translucent_pass.py holds ForwardTranslucent alone.)

Tolerances: the frames' LDR image, SceneColor and SceneVelocity to
test_torch_forward.py's bounds (2e-4 on all but 0.2 % of values, means
within 1e-5: a whole frame composes its passes).
"""

import numpy as np
import pytest
import torch

from test_torch_passes import RES
from test_torch_translucent import _cfgs, glass_panes

torch.set_num_threads(2)


def render_both(build, layers, frames=1, **flags):
    """One scene builder's frames through both Renderers: (port renderer,
    JAX renderer, port LDR, JAX LDR)."""
    from arkoserenderer_torch.models.standard import Renderer as TRenderer
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer

    jcfg, tcfg = _cfgs()
    kw = dict(taa=False, bloom=False, oit_layers=layers, **flags)
    jr = JRenderer(*build("jax"), jcfg, **kw)
    tr = TRenderer(*build("torch"), tcfg, device="cpu", **kw)
    for _ in range(frames):
        ref = np.array(jr.render_frame())
        ours = tr.render_frame().numpy()
    return tr, jr, ours, ref


def _assert_frame_close(ours, ref):
    diff = np.abs(ours - ref)
    assert (diff > 2e-4).mean() < 0.002, (diff > 2e-4).mean()
    assert abs(ours.mean() - ref.mean()) < 1e-5


@pytest.fixture(scope="module", params=[(False, 1), (True, 1), (False, 4), (True, 4)],
                ids=["front-1", "both-1", "front-4", "both-4"])
def pane_frames(request):
    with_back, layers = request.param
    return with_back, layers, render_both(lambda pkg: glass_panes(pkg, with_back), layers)


def test_translucent_frame_matches_jax(pane_frames):
    """The whole frame (ForwardTranslucent after SkyView) and the resources
    the pass publishes, port against the JAX Renderer."""
    _, layers, (tr, jr, ours, ref) = pane_frames
    names = [p.name for p in tr.pipeline.passes]
    assert names == [p.name for p in jr.pipeline.passes]
    assert names.index("ForwardTranslucent") == names.index("SkyView") + 1
    assert tr.pipeline.passes[names.index("ForwardTranslucent")].layers == layers
    assert np.isfinite(ours).all() and ours.shape == (RES, RES, 3)
    _assert_frame_close(ours, ref)
    for key in ("SceneColor", "SceneVelocity"):
        _assert_frame_close(tr.state[key].numpy(), np.asarray(jr.state[key]))
