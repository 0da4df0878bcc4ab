"""The port's path tracer against the JAX package's: ``trace_path`` through
``PathTracer`` at 32^2 on the test scene with one sphere (1 sample a pixel,
seed 7, two bounces: textures at ray-cone mips, the environment, the sun's
NEE, diffuse and GGX bounces), the `pathtraced` golden (test_golden.py's
case: 256^2, 4 samples) on the CPU, ``PathTracer``'s bookkeeping (the
reset on a camera move, a checkpoint round trip; both also against JAX's
tracer, with the accumulation kept in place), and the bench's pathtraced
and rt_soft kinds at their small size.

Both sides draw the same random numbers (``core/prng`` equals
``jax.random`` bit for bit) and trace the same BVH. Radiance is held to
rtol 1e-4 / atol 1e-5 on at least 99 % of the pixels, every pixel finite:
a bounce ray whose origin moved by an ulp (XLA:CPU fuses multiply-adds,
eager torch rounds each operation) can hit another triangle or another
texel and take its pixel anywhere, which the remainder allows. (None does
at this size.)
"""

import numpy as np
import pytest
import torch

from arkoserenderer_torch.assets import procedural as tproc
from arkoserenderer_torch.models.pathtracer import PathTracer as TPathTracer

torch.set_num_threads(2)

RTOL, ATOL, SHARE = 1e-4, 1e-5, 0.99


def assert_radiance_close(ours, ref, share=SHARE):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    ok = np.isclose(ours, ref, rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= share, f"{ok.mean():.4%} of pixels within tolerance"


@pytest.fixture(scope="module")
def jax_tracer():
    """JAX's tracer at 32^2, two bounces, seed 7 (one compile of its jitted
    step for the module), and its camera's first position."""
    from arkoserenderer_tpu.assets import procedural as jproc
    from arkoserenderer_tpu.models.pathtracer import PathTracer as JPathTracer

    js, jc = jproc.build_test_scene(viewport=(32, 32), n_spheres=1)
    return JPathTracer(js, jc, 32, 32, max_bounces=2, seed=7), jc.position.copy()


def port_tracer(seed: int = 7):
    ts, tc = tproc.build_test_scene(viewport=(32, 32), n_spheres=1)
    return TPathTracer(ts, tc, 32, 32, max_bounces=2, seed=seed, device="cpu")


def test_trace_path_matches_jax(jax_tracer):
    j, _ = jax_tracer
    ref = np.asarray(j.render_sample(1))
    ours = port_tracer().render_sample(1)
    assert_radiance_close(ours.numpy(), ref)
    assert ref.max() > 0.1  # lit, not black


def test_accumulation_reset_and_checkpoint_match_jax(jax_tracer, tmp_path):
    """The accumulation in place, the reset on a camera move and a
    checkpoint round trip against JAX's tracer: two samples from the start,
    two after a move (both reset), then the port's checkpoint loaded by
    JAX's tracer (moved on past it) and by a new port tracer of another
    seed, each taking one more sample. The accumulation keeps its storage
    throughout (a captured sample reads and writes that buffer)."""
    j, start = jax_tracer
    j.camera.position = start.copy()
    j.render_sample(1)
    j.reset()
    t = port_tracer()
    accum = t.accum.data_ptr()
    assert_radiance_close(t.render_sample(2).numpy(), j.render_sample(2))
    for cam in (j.camera, t.camera):
        cam.position = cam.position + np.array([0.3, 0.0, 0.0], np.float32)
    assert_radiance_close(t.render_sample(2).numpy(), j.render_sample(2))
    assert t.sample_count == j.sample_count == 2  # both reset on the move
    path = str(tmp_path / "pt.npz")
    t.save_checkpoint(path)
    resumed = port_tracer(seed=0)
    resumed.camera.position = t.camera.position.copy()
    kept = resumed.accum.data_ptr()
    resumed.load_checkpoint(path)
    j.render_sample(1)
    j.load_checkpoint(path)
    assert_radiance_close(resumed.render_sample(1).numpy(), j.render_sample(1))
    assert resumed.sample_count == 3 and resumed.accum.data_ptr() == kept
    assert t.accum.data_ptr() == accum


def test_pathtraced_golden():
    """tests/goldens/pathtraced.png rendered by the port on the CPU, within
    the golden test's thresholds."""
    from arkoserenderer_torch.utils.imageio import load_png, to_u8
    from test_torch_forward import GOLDENS, assert_golden_close

    scene, cam = tproc.build_test_scene(viewport=(256, 256), n_spheres=1)
    t = TPathTracer(scene, cam, 256, 256, max_bounces=2, seed=7, device="cpu")
    t.render_sample(4)
    assert_golden_close(to_u8(t.ldr().numpy()), load_png(str(GOLDENS / "pathtraced.png"))[..., :3])


@pytest.fixture(scope="module")
def small_scene():
    def make():
        return tproc.build_test_scene(viewport=(16, 12), n_spheres=1)
    return make


def test_reset_on_camera_move(small_scene):
    """Samples accumulate while the camera stands; a moved camera restarts
    the accumulation at sample 0, as a fresh tracer there would."""
    scene, cam = small_scene()
    t = TPathTracer(scene, cam, 16, 12, max_bounces=1, seed=3, device="cpu")
    first = t.render_sample(1).clone()
    t.render_sample(2)
    assert t.sample_count == 3 and not torch.equal(t.radiance(), first)
    cam.position = cam.position + np.array([0.3, 0.0, 0.0], np.float32)
    moved = t.render_sample(1)
    assert t.sample_count == 1
    scene2, cam2 = small_scene()
    cam2.position = cam.position.copy()
    fresh = TPathTracer(scene2, cam2, 16, 12, max_bounces=1, seed=3, device="cpu")
    assert torch.equal(moved, fresh.render_sample(1))
    assert not torch.equal(moved, first)
    t.reset()
    assert t.sample_count == 0 and not t.accum.any()


def test_checkpoint_round_trip(small_scene, tmp_path):
    """Two samples, a checkpoint, a new tracer that loads it and takes a
    third: equal bit for bit to three uninterrupted samples."""
    scene, cam = small_scene()
    a = TPathTracer(scene, cam, 16, 12, max_bounces=2, seed=5, device="cpu")
    a.render_sample(2)
    path = str(tmp_path / "pt.npz")
    a.save_checkpoint(path)
    scene_b, cam_b = small_scene()
    b = TPathTracer(scene_b, cam_b, 16, 12, max_bounces=2, seed=0, device="cpu")
    b.load_checkpoint(path)
    assert b.sample_count == 2 and b._seed == 5
    b.render_sample(1)
    scene_c, cam_c = small_scene()
    c = TPathTracer(scene_c, cam_c, 16, 12, max_bounces=2, seed=5, device="cpu")
    c.render_sample(3)
    assert b.sample_count == 3 and torch.equal(b.radiance(), c.radiance())
    ldr = b.ldr()
    assert ldr.shape == (12, 16, 3) and float(ldr.min()) >= 0.0 and float(ldr.max()) <= 1.0


def test_bench_kinds_small():
    """The bench's two new kinds at their small size on the CPU: the
    pathtraced tracer (the app's settings: three bounces, AA) takes seven
    traces a sample by label, and rt_soft's Renderer has both soft
    stacks and five traces a frame."""
    from arkoserenderer_torch.tools import bench

    tracer = bench.build_pathtracer(small=True, device="cpu")
    assert (tracer.width, tracer.height, tracer.max_bounces, tracer.aa) == (256, 256, 3, True)
    assert bench.expected_trace_launches_by_label(tracer, 2) == {
        **{f"pt ray {b}": 2 for b in range(4)}, **{f"pt sun {b}": 2 for b in range(3)}}
    assert bool(torch.isfinite(tracer.render_sample(1)).all())
    r = bench.build_renderer("rt_soft", small=True, device="cpu")
    assert r.cfg.scene.sun_angular_radius_deg == bench.SOFT_SUN_DEG
    assert r.cfg.scene.spot_source_radius == (bench.SOFT_SPOT_RADIUS,)
    assert sorted(bench.expected_trace_launches_by_label(r, 1)) == [
        "reflection", "spot mask 0", "spot occlusion 0", "sun mask", "sun occlusion"]
    img = r.render_frames(2)
    assert bool(torch.isfinite(img).all())
    assert {"RTShadow.history", "RTLocalShadow.history"} <= set(r.state)
