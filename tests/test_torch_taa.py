"""The port's TAA pass under ``taa_filter="bilinear"`` against the JAX
package's, at 96^2 over three frames, each frame's inputs seeded (an HDR
SceneColor in [0, 4)) and its history JAX's output of the frame before:

  * "still": a still camera's zero velocity; "slow": a drifting camera's
    field, every component within a pixel. Both take the reference's
    shift branch (nine weighted static shifts);
  * "moving": a camera panning 2.5 px a frame, a gather branch frame;
  * "catmull override": ``use_catmull_rom=True`` under the bilinear config
    resamples with Catmull-Rom, as the reference's argument does.

SceneColor and TAAHistory are held within 1e-5 (the per-pass tolerance).
The two bilinear branches round differently (up to ~2e-5 apart), so each
frame is also held to JAX's within 2e-6: a frame that took the other
branch would not be.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.rendering.passes.taa import TAAPass as TTAAPass
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.rendering.registry import Registry as TRegistry
from arkoserenderer_tpu.rendering.passes.taa import TAAPass as JTAAPass
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from arkoserenderer_tpu.rendering.registry import Registry as JRegistry

torch.set_num_threads(2)

RES = 96
FRAMES = 3
CASES = {"still": 0.0, "slow": 0.9, "moving": 2.5, "catmull override": 2.5}


def velocity(case: str, rng) -> np.ndarray:
    """(RES, RES, 2) pixels: zero, a field within +-0.9, or a 2.5 px pan
    with +-0.5 of noise."""
    if case == "still":
        return np.zeros((RES, RES, 2), np.float32)
    if case == "slow":
        return rng.uniform(-0.9, 0.9, (RES, RES, 2)).astype(np.float32)
    pan = np.array([CASES[case], -0.5], np.float32)
    return (pan + rng.uniform(-0.5, 0.5, (RES, RES, 2))).astype(np.float32)


def construct(case: str):
    """The TAA execute of each package at the bilinear filter."""
    catmull = True if case == "catmull override" else None
    out = []
    for cfg_cls, reg_cls, pass_cls, extra in (
            (TPipelineConfig, TRegistry, TTAAPass, ("cpu",)),
            (JPipelineConfig, JRegistry, JTAAPass, ())):
        reg = reg_cls()
        dtype = torch.float32 if extra else np.float32
        reg.create("SceneColor", (RES, RES, 3), dtype)
        reg.create("SceneVelocity", (RES, RES, 2), dtype)
        cfg = cfg_cls(width=RES, height=RES, taa_filter="bilinear")
        out.append(pass_cls(use_catmull_rom=catmull).construct(cfg, reg, *extra))
    return out[0], jax.jit(out[1])


@pytest.fixture(scope="module", params=sorted(CASES))
def taa_walk(request):
    """[(torch, jax) updates] of each frame, each package fed JAX's
    history."""
    case = request.param
    texec, jexec = construct(case)
    rng = np.random.default_rng(17)
    history = np.zeros((RES, RES, 3), np.float32)
    out = []
    for frame in range(FRAMES):
        color = rng.uniform(0.0, 4.0, (RES, RES, 3)).astype(np.float32)
        vel = velocity(case, rng)
        tstate = {"SceneColor": torch.from_numpy(color), "SceneVelocity": torch.from_numpy(vel),
                  "TAAHistory": torch.from_numpy(history.copy())}
        jstate = {"SceneColor": jnp.asarray(color), "SceneVelocity": jnp.asarray(vel),
                  "TAAHistory": jnp.asarray(history)}
        tupd = texec(tstate, TFrameContext(scene=None, camera=None, frame_index=frame,
                                           delta_time=1 / 60))
        jupd = jexec(jstate, JFrameContext(scene=None, camera=None,
                                           frame_index=jnp.asarray(frame, jnp.int32),
                                           delta_time=jnp.asarray(1 / 60, jnp.float32),
                                           row_offset=jnp.zeros((), jnp.int32)))
        out.append((tupd, jupd, color))
        history = np.asarray(jupd["TAAHistory"])
    return case, out


def test_bilinear_taa_matches_jax(taa_walk):
    case, out = taa_walk
    for frame, (tupd, jupd, _) in enumerate(out):
        assert set(tupd) == set(jupd) == {"SceneColor", "TAAHistory"}
        for key in ("SceneColor", "TAAHistory"):
            o, r = tupd[key].numpy(), np.asarray(jupd[key])
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-5, err_msg=f"{case} {key}")
            assert np.abs(o - r).max() <= 2e-6, (case, frame, key, np.abs(o - r).max())
    # Frame 0 takes the frame wholesale (hist + (color - hist), to an ulp);
    # later frames blend in the history.
    np.testing.assert_allclose(out[0][0]["SceneColor"].numpy(), out[0][2], rtol=0, atol=1e-6)
    tupd, _, color = out[-1]
    assert (np.abs(tupd["SceneColor"].numpy() - color) > 1e-3).mean() > 0.5
