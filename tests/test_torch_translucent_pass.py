"""ForwardTranslucent alone, the port against the JAX package: the port's
pass fed the JAX frame's state before it, on the two-pane scene of
tests/test_translucent.py at 96^2 with 1 and 4 layers. Tolerance:
test_torch_passes.py's COLOR_ATOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from test_torch_passes import COLOR_ATOL, _np
from test_torch_translucent import _cfgs, glass_panes

torch.set_num_threads(2)


def _pipelines(layers: int):
    from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make
    from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make

    jcfg, tcfg = _cfgs()
    jst = glass_panes("jax", True)[0].static_info()
    tst = glass_panes("torch", True)[0].static_info()
    kw = dict(taa=False, bloom=False, oit_layers=layers)
    return (j_make(dataclasses.replace(jcfg, scene=jst), **kw),
            t_make(dataclasses.replace(tcfg, scene=tst), device="cpu", **kw))


@pytest.fixture(scope="module")
def before_pass():
    """The JAX frame's state before ForwardTranslucent (the passes before it
    do not depend on the layer count), with both packages' frame contexts:
    (pass names before it, state, JAX context, port context)."""
    from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
    from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext

    jscene, jcam = glass_panes("jax", True)
    jpipe, _ = _pipelines(1)
    jsa, jcs = jscene.build(), jcam.state(0)
    jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(0, jnp.int32),
                         delta_time=jnp.asarray(1 / 60, jnp.float32),
                         row_offset=jnp.zeros((), jnp.int32))
    tctx = TFrameContext(scene=bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu"),
                         camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                         frame_index=0, delta_time=1 / 60)
    state = jpipe.initial_state()
    state["scene.version"] = jnp.asarray(0, jnp.int32)
    names = []
    for name, jexec in jpipe._executes:
        if name == "ForwardTranslucent":
            return names, state, jctx, tctx
        names.append(name)
        state = {**state, **jax.jit(jexec)(state, jctx)}
    raise AssertionError(f"no ForwardTranslucent among {names}")


@pytest.mark.parametrize("layers", [1, 4])
def test_translucent_pass_matches_jax_on_its_inputs(before_pass, layers):
    """ForwardTranslucent alone on the two-pane scene: the port's pass fed
    the JAX frame's state before it (SkyView's output), against JAX's pass
    on the same state."""
    names, state, jctx, tctx = before_pass
    jpipe, tpipe = _pipelines(layers)
    jexecs, texecs = dict(jpipe._executes), dict(tpipe._executes)
    assert [n for n, _ in jpipe._executes][:len(names) + 1] == names + ["ForwardTranslucent"]
    assert [n for n, _ in tpipe._executes][:len(names) + 1] == names + ["ForwardTranslucent"]
    jupd = jax.jit(jexecs["ForwardTranslucent"])(state, jctx)
    tupd = texecs["ForwardTranslucent"](bridge.frame_state_from_numpy(state, "cpu"), tctx)
    assert set(tupd) == set(jupd) == {"SceneColor", "SceneVelocity"}
    for key in sorted(jupd):
        np.testing.assert_allclose(_np(tupd[key]), np.asarray(jupd[key]), atol=COLOR_ATOL[key],
                                   rtol=0, err_msg=key)
    moved = np.abs(np.asarray(jupd["SceneColor"]) - np.asarray(state["SceneColor"])).max(-1)
    assert (moved > 1e-3).sum() > 200   # the panes blend over many pixels
