"""The port's Renderer host API against the JAX package's, on the CPU.

* The twins of ``tests/test_checkpoint.py``'s three cases that run in
  tier 1: a checkpoint after 3 frames restored into a fresh renderer gives
  the uninterrupted frame 4 (atol 1e-5, the reference test's), the frame
  retry recovers from one injected failure with the TAA history kept, and
  gives up after its retries.
* A checkpoint written by the JAX Renderer after 3 frames loads into the
  port's (the same npz layout), and the port's next frame matches JAX's
  next frame. A whole frame composes its nine passes, so it is held to the
  whole-frame bound of ``tests/test_torch_forward.py``'s TAA frames (LDR
  within 2e-4 on all but 0.2 % of values, means within 1e-5); the pass
  walk's 1e-5 holds each pass on its own inputs. Without the checkpoint
  the same frame differs by more than 1e-3 (its TAA history is JAX's).
* ``pick`` equal to JAX's at a 4x4 grid of pixels of a 128^2 frame:
  instance and triangle exactly, depth within 1e-6, distance within rtol
  1e-5 (the sky gives -1 and None on both).
* ``reconstruct(rebuild_passes=True)`` keeps the TAA history bit for bit
  (the twin of ``test_aux.py::test_renderer_reconstruct_preserves_history``).
* ``validate_frame``: a clean frame reports nothing; a NaN in the
  environment map is blamed on the same (pass, resource) pairs as JAX's
  validate_frame names (the twin of ``test_aux.py::test_validate_frame_clean_
  and_detects_nans``); a NaN in the vertex pool reaches NamedTuple leaves
  ("vis.setup.screen_xy").
* ``utils/memstats`` on a CPU device reads zeros and keeps the "HBM"
  wording; ``utils/timing.time_passes`` and ``Renderer.benchmark`` refuse a
  CPU pipeline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.assets.procedural import build_test_scene as t_build
from arkoserenderer_torch.core.types import RasterConfig as TRaster
from arkoserenderer_torch.models.standard import Renderer as TRenderer
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TCfg
from arkoserenderer_torch.rendering.pipeline import validate_frame as t_validate
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build
from arkoserenderer_tpu.core.types import RasterConfig as JRaster
from arkoserenderer_tpu.models.standard import Renderer as JRenderer
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JCfg
from arkoserenderer_tpu.rendering.pipeline import validate_frame as j_validate
from test_torch_passes import _np

torch.set_num_threads(2)

RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)


def t_cfg(res):
    return TCfg(width=res, height=res, raster=TRaster(**RASTER), shadow_map_size=128)


def j_cfg(res):
    return JCfg(width=res, height=res, raster=JRaster(**RASTER), shadow_map_size=128)


def t_renderer(res=96, n_spheres=1, **kw):
    scene, cam = t_build(viewport=(res, res), n_spheres=n_spheres)
    return TRenderer(scene, cam, t_cfg(res), device="cpu", **kw)


def test_checkpoint_resume_continues_taa_history(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    r = t_renderer(taa=True, bloom=False)
    for _ in range(3):
        r.render_frame()
    r.save_checkpoint(path)
    expected = r.render_frame().numpy().copy()  # frame 4, uninterrupted

    r2 = t_renderer(taa=True, bloom=False)
    r2.load_checkpoint(path)
    assert r2.frame_index == 3
    resumed = r2.render_frame().numpy()
    np.testing.assert_allclose(resumed, expected, atol=1e-5)


def test_render_frame_safe_recovers_from_one_failure():
    r = t_renderer(taa=True, bloom=False)
    r.render_frame()
    hist_before = r.state["TAAHistory"].clone()
    calls = {"n": 0}
    orig = r.pipeline.render_frame

    def flaky(*a, **kw):
        if calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected device loss")
        return orig(*a, **kw)

    r.pipeline.render_frame = flaky
    out = r.render_frame_safe().numpy()
    assert np.isfinite(out).all() and out.max() > 0
    assert (r.state["TAAHistory"] - hist_before).abs().max() > 0  # advanced, not re-cleared
    assert calls["n"] == 1


def test_render_frame_safe_gives_up_after_retries():
    r = t_renderer(taa=False, bloom=False)

    def always_fail(*a, **kw):
        raise RuntimeError("permanent failure")

    r.pipeline.render_frame = always_fail
    with pytest.raises(RuntimeError, match="permanent failure"):
        r.render_frame_safe(retries=1)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    js, jc = j_build(viewport=(96, 96), n_spheres=1)
    jr = JRenderer(js, jc, j_cfg(96), taa=True, bloom=False)
    for _ in range(3):
        jr.render_frame()
    jr.save_checkpoint(path)
    ref = np.array(jr.render_frame())
    ref_vis = np.array(jr.state["Visibility"])

    r = t_renderer(taa=True, bloom=False)
    r.load_checkpoint(path)
    assert (r.frame_index, r.time) == (3, jr.time - 1 / 60)
    with np.load(path) as z:
        loaded = {k[len("state."):] for k in z.files if k.startswith("state.")}
    assert "TAAHistory" in loaded and loaded <= set(r.state)
    ours = r.render_frame().numpy()
    assert (_np(r.state["Visibility"]) == ref_vis).mean() > 0.999
    diff = np.abs(ours - ref)
    assert (diff > 2e-4).mean() < 0.002, (diff > 2e-4).mean()
    assert abs(ours.mean() - ref.mean()) < 1e-5
    fresh = t_renderer(taa=True, bloom=False)
    fresh.frame_index = 3
    assert np.abs(fresh.render_frame().numpy() - ref).max() > 1e-3


def test_pick_matches_jax():
    js, jc = j_build(viewport=(128, 128))
    jr = JRenderer(js, jc, j_cfg(128), taa=False, bloom=False)
    jr.render_frame()
    scene, cam = t_build(viewport=(128, 128))
    r = TRenderer(scene, cam, t_cfg(128), device="cpu", taa=False, bloom=False)
    r.render_frame()
    hits = 0
    for y in np.linspace(4, 123, 4).astype(int):
        for x in np.linspace(4, 123, 4).astype(int):
            ours, ref = r.pick(int(x), int(y)), jr.pick(int(x), int(y))
            assert (ours["instance"], ours["triangle"]) == (ref["instance"], ref["triangle"])
            assert abs(ours["depth"] - ref["depth"]) < 1e-6
            if ref["distance"] is None:
                assert ours["distance"] is None and ours["instance"] == -1
            else:
                np.testing.assert_allclose(ours["distance"], ref["distance"], rtol=1e-5)
                hits += ours["instance"] >= 0
    assert hits >= 4


def test_renderer_reconstruct_preserves_history():
    r = t_renderer(n_spheres=3)
    for _ in range(3):
        r.render_frame()
    hist_before = r.state["TAAHistory"].clone()
    pipeline_before = r.pipeline
    r.reconstruct(rebuild_passes=True)
    assert r.pipeline is not pipeline_before
    assert torch.equal(r.state["TAAHistory"], hist_before)
    assert np.isfinite(r.render_frame().numpy()).all()  # keeps rendering


@pytest.fixture(scope="module")
def validated():
    """Both packages' 64^2 frame and their validate_frame inputs."""
    js, jc = j_build(viewport=(64, 64))
    jr = JRenderer(js, jc, j_cfg(64), taa=False, bloom=False)
    jr.render_frame()
    r = t_renderer(res=64, n_spheres=3, taa=False, bloom=False)
    r.render_frame()
    j_inputs = {k: jr.state[k] for k in jr.pipeline.registry.persistent_names if k in jr.state}
    j_inputs["scene.version"] = jnp.asarray(1, jnp.int32)
    t_inputs = {k: r.state[k] for k in r.pipeline.registry.persistent_names if k in r.state}
    t_inputs["scene.version"] = 1
    return jr, jc, j_inputs, r, t_inputs


def test_validate_frame_clean_and_detects_nans(validated):
    jr, jc, j_inputs, r, t_inputs = validated
    cam = r.camera
    assert t_validate(r.pipeline, t_inputs, r.scene_arrays, cam.state(1, "cpu"),
                      frame_index=1) == []
    env = r.scene_arrays.env_map.clone()
    env[0, 0, 0] = float("nan")
    findings = t_validate(r.pipeline, t_inputs, r.scene_arrays._replace(env_map=env),
                          cam.state(1, "cpu"), frame_index=1)
    assert findings, "NaN injection must be detected"
    assert any(f["pass"] in ("SkyView", "LightingCompose") for f in findings)
    bad_j = jr.scene_arrays._replace(env_map=jr.scene_arrays.env_map.at[0, 0, 0].set(jnp.nan))
    ref = j_validate(jr.pipeline, j_inputs, bad_j, jc.state(1), frame_index=1)
    assert {(f["pass"], f["resource"]) for f in findings} == {
        (f["pass"], f["resource"]) for f in ref}


def test_validate_frame_names_tuple_leaves(validated):
    *_, r, t_inputs = validated
    pos = r.scene_arrays.positions.clone()
    pos[0, 0] = float("nan")
    findings = t_validate(r.pipeline, t_inputs, r.scene_arrays._replace(positions=pos),
                          r.camera.state(1, "cpu"), frame_index=1)
    resources = {f["resource"] for f in findings if f["pass"] == "Geometry"}
    assert "vis.setup.screen_xy" in resources, resources
    assert all(f["non_finite"] > 0 and isinstance(f["shape"], tuple) for f in findings)


def test_memstats_on_the_cpu():
    from arkoserenderer_torch.utils import memstats

    s = memstats.snapshot("cpu")
    assert (s.bytes_in_use, s.bytes_limit, s.peak_bytes_in_use, s.used_fraction) == (0, 0, 0, 0.0)
    h = memstats.MemHistory()
    assert h.format() == "no samples"
    h.poll("cpu")
    assert "HBM" in h.format() and h.history_mb() == [0.0]


def test_timing_refuses_the_cpu():
    from arkoserenderer_torch.utils.timing import format_timings, time_passes

    r = t_renderer(res=32, taa=False, bloom=False)
    with pytest.raises(RuntimeError, match="card"):
        time_passes(r.pipeline, r.pipeline.initial_state(), r.scene_arrays,
                    r.camera.state(1, "cpu"))
    with pytest.raises(RuntimeError, match="card"):
        r.benchmark()
    table = format_timings({"<frame>": 20.0, "Geometry": 1.5})
    assert "over budget" in table.splitlines()[1] and "over" not in table.splitlines()[2]
