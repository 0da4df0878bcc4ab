"""The nine-shift history fetch of the soft-shadow denoiser, the reflection
denoiser and TemporalUpscale against the JAX package's, at 96^2 over three
frames, each frame's history JAX's output of the frame before:

  * "sub-pixel": a drifting field, every velocity component within 0.9 px
    (TemporalUpscale: every display-space speed within a pixel), which
    takes the reference's shift branch (nine weighted static shifts);
  * "pan": a 2.5 px pan with +-0.5 px of noise, the gather branch.

Every output is held within 1e-5 (the per-pass tolerance of
tests/test_torch_taa.py), relative above 1 (the sample counts). The two
branches round differently (up to ~2e-5 apart on these values), so each
denoiser frame is also held to JAX's within 2e-6: a port that took the
other branch would not be (an always-gathering port is 1.5e-5 off in the
first sub-pixel frame). TemporalUpscale clamps the history to the current
neighbourhood, whose deviation XLA and torch round apart (a few 1e-6 on a
few pixels whichever branch), so there at most 1 % of UpscaleHistory's
values may be more than 1e-6 from JAX's (0.4 % are; an always-gathering
port puts 6.9 % there in the first sub-pixel frame); LDRDisplay, through
CAS's reciprocal, is held within tests/test_torch_upscale.py's 2e-5. The
upscale walk starts past frame 0 (which drops the history) from a seeded
history. Each package's predicate is its own: the denoisers look at the
largest velocity component, TemporalUpscale at the largest speed in
display pixels after the resize.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.ops import reflection_denoise as trd
from arkoserenderer_torch.ops import shadow_denoise as tsd
from arkoserenderer_torch.rendering.passes.upscale import TemporalUpscalePass as TUpscale
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.rendering.registry import Registry as TRegistry
from arkoserenderer_tpu.ops import reflection_denoise as jrd
from arkoserenderer_tpu.ops import shadow_denoise as jsd
from arkoserenderer_tpu.rendering.passes.upscale import TemporalUpscalePass as JUpscale
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from arkoserenderer_tpu.rendering.registry import Registry as JRegistry

torch.set_num_threads(2)

RES = 96
RENDER = 64  # TemporalUpscale renders 64^2 to a 96^2 display
FRAMES = 3
ATOL, BRANCH_ATOL = 1e-5, 2e-6
UPSCALE_ATOL, UPSCALE_SHARE = 1e-6, 0.01
CAS_ATOL = 2e-5  # LDRDisplay, through CAS: tests/test_torch_upscale.py's bound
CASES = ("sub-pixel", "pan")
Cam = collections.namedtuple("Cam", "jitter_px")  # what TemporalUpscale reads of the camera


def velocity(case: str, rng, size: int, within: float = 0.9) -> np.ndarray:
    if case == "sub-pixel":
        return rng.uniform(-within, within, (size, size, 2)).astype(np.float32)
    return (np.array([2.5, -0.5], np.float32)
            + rng.uniform(-0.5, 0.5, (size, size, 2))).astype(np.float32)


def pixel_grid(size: int):
    xs = np.arange(size, dtype=np.float32) + 0.5
    return tuple(g.ravel() for g in np.meshgrid(xs, xs))


def close(ours, ref, name, branch=True, atol=ATOL):
    """Within ATOL (relative above 1); ``branch`` True: also within
    BRANCH_ATOL, a float: at most that share of values off by more than
    UPSCALE_ATOL."""
    o = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    r = np.asarray(ref)
    assert o.shape == r.shape, name
    err = np.abs(o - r) / np.maximum(1.0, np.abs(r))
    assert err.max() <= atol, (name, float(err.max()))
    if branch is True:
        assert err.max() <= BRANCH_ATOL, (name, "the other branch?", float(err.max()))
    elif branch:
        share = float((err > UPSCALE_ATOL).mean())
        assert share <= branch, (name, "the other branch?", share)


def denoiser_walk(case: str, which: str):
    """[(torch outputs, JAX outputs)] of ``which`` ("shadow" with two planes
    or "reflection") reproject over FRAMES frames."""
    rng = np.random.default_rng(5 if which == "shadow" else 6)
    c = 2 if which == "shadow" else 3
    width = 2 * c + 1 if which == "shadow" else 3
    px, py = pixel_grid(RES)
    ramp = 0.3 + 0.002 * np.arange(RES)[None, :] + 0.001 * np.arange(RES)[:, None]
    hist = rng.uniform(0.0, 4.0, (RES, RES, c)).astype(np.float32)
    mom = rng.uniform(0.0, 4.0, (RES, RES, width)).astype(np.float32)
    mom[..., -1] = rng.integers(0, 24, (RES, RES))
    prev_depth = ramp.astype(np.float32)
    t_mod, j_mod = (tsd, jsd) if which == "shadow" else (trd, jrd)
    j_fn = jax.jit(j_mod.reproject)
    out = []
    for _ in range(FRAMES):
        depth = (ramp + rng.normal(0, 1e-4, ramp.shape)).astype(np.float32)
        vel = velocity(case, rng, RES)
        args = (hist, mom, prev_depth, depth, vel, px, py)
        ours = t_mod.reproject(*(torch.from_numpy(a.copy()) for a in args))
        ref = j_fn(*(jnp.asarray(a) for a in args))
        out.append((ours, ref))
        hist, mom = np.array(ref[0]), np.array(ref[1])
        prev_depth = depth
    return out


def upscale_walk(case: str):
    """[(torch updates, JAX updates)] of TemporalUpscale over FRAMES frames."""
    rng = np.random.default_rng(7)
    passes = []
    for cfg_cls, reg_cls, pass_cls, extra in (
            (TPipelineConfig, TRegistry, TUpscale, ("cpu",)),
            (JPipelineConfig, JRegistry, JUpscale, ())):
        reg = reg_cls()
        dtype = torch.float32 if extra else np.float32
        reg.create("LDR", (RENDER, RENDER, 3), dtype)
        reg.create("SceneVelocity", (RENDER, RENDER, 2), dtype)
        cfg = cfg_cls(width=RENDER, height=RENDER)
        passes.append(pass_cls(RES, RES).construct(cfg, reg, *extra))
    texec, jexec = passes[0], jax.jit(passes[1])
    history = rng.uniform(0.0, 1.0, (RES, RES, 3)).astype(np.float32)
    out = []
    for frame in range(1, FRAMES + 1):  # past frame 0, which drops the history
        ldr = rng.uniform(0.0, 1.0, (RENDER, RENDER, 3)).astype(np.float32)
        # Display speed = render speed * 1.5: within 0.45 render px a
        # component keeps every speed under 0.96 display px.
        vel = velocity(case, rng, RENDER, within=0.45)
        jitter = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
        tstate = {"LDR": torch.from_numpy(ldr), "SceneVelocity": torch.from_numpy(vel),
                  "UpscaleHistory": torch.from_numpy(history.copy())}
        jstate = {"LDR": jnp.asarray(ldr), "SceneVelocity": jnp.asarray(vel),
                  "UpscaleHistory": jnp.asarray(history)}
        tcam = Cam(torch.from_numpy(jitter))
        jcam = Cam(jnp.asarray(jitter))
        tupd = texec(tstate, TFrameContext(scene=None, camera=tcam, frame_index=frame,
                                           delta_time=1 / 60))
        jupd = jexec(jstate, JFrameContext(scene=None, camera=jcam,
                                           frame_index=jnp.asarray(frame, jnp.int32),
                                           delta_time=jnp.asarray(1 / 60, jnp.float32),
                                           row_offset=jnp.zeros((), jnp.int32)))
        out.append((tupd, jupd))
        history = np.array(jupd["UpscaleHistory"])
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("which", ["shadow", "reflection"])
def test_denoiser_history_branch_matches_jax(which, case):
    for frame, (ours, ref) in enumerate(denoiser_walk(case, which)):
        for name, o, r in zip(("hist", "moments", "confidence"), ours, ref):
            close(o, r, f"{which} {case} frame {frame} {name}")
        assert 0.2 < float(ours[2].mean()) <= 1.0  # the depth test passes and trips


@pytest.mark.parametrize("case", CASES)
def test_temporal_upscale_history_branch_matches_jax(case):
    walk = upscale_walk(case)
    for frame, (tupd, jupd) in enumerate(walk):
        assert set(tupd) == set(jupd) == {"LDRDisplay", "UpscaleHistory"}
        for key in sorted(tupd):
            close(tupd[key], jupd[key], f"{case} frame {frame} {key}",
                  branch=UPSCALE_SHARE if key == "UpscaleHistory" else False,
                  atol=ATOL if key == "UpscaleHistory" else CAS_ATOL)
    # The history is blended in, not taken wholesale.
    assert not np.allclose(walk[1][0]["UpscaleHistory"].numpy(), walk[0][0]["UpscaleHistory"])
