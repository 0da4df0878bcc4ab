"""The port's whole frames against the JAX package's and the committed
goldens.

At 256^2, the `forward` golden's config (taa=False, bloom=False, one frame)
and the `full_post` golden's (ssao, motion_blur, TAA and Bloom, three
frames), under the golden test's thresholds (tests/test_golden.py: mean abs
diff < 1.5 and under 0.5 % of pixels off by more than 24, on uint8 images).
At 96^2, the LDR of the forward frame with TAA and Bloom after three frames
of a moving camera, port against the JAX Renderer, to the bound stated in
the test; and one frame pair of each of the bench's frame kinds on the CPU.
Also the static sun-shadow cache's host branch and the port's PNG reader."""

from pathlib import Path

import numpy as np
import pytest
import torch

from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import Renderer as TRenderer
from arkoserenderer_torch.ops import raster as traster
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.utils.imageio import load_png, to_u8

# The tests run beside other workers: a few intra-op threads a process keep
# eager torch from spinning on cores it does not have.
torch.set_num_threads(2)

GOLDENS = Path(__file__).parent / "goldens"
RES = 256
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)


def port_cfg(res=RES, shadow=256):
    return TPipelineConfig(width=res, height=res, raster=TRasterConfig(**RASTER),
                           shadow_map_size=shadow)


def assert_golden_close(img_u8, ref_u8):
    diff = np.abs(img_u8.astype(int) - ref_u8.astype(int))
    assert diff.mean() < 1.5, f"mean abs diff {diff.mean():.3f}"
    assert (diff > 24).mean() < 0.005, f"{(diff > 24).mean():.2%} pixels changed"


@pytest.fixture(scope="module")
def port_image():
    scene, cam = t_build_test_scene(viewport=(RES, RES))
    img = TRenderer(scene, cam, port_cfg(), device="cpu", taa=False, bloom=False).render_frame()
    assert img.shape == (RES, RES, 3) and np.isfinite(img.numpy()).all()
    return to_u8(img.numpy())


def test_forward_matches_live_jax_render(port_image):
    from arkoserenderer_tpu.assets.procedural import build_test_scene
    from arkoserenderer_tpu.core.types import RasterConfig
    from arkoserenderer_tpu.models.standard import Renderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig

    scene, cam = build_test_scene(viewport=(RES, RES))
    cfg = PipelineConfig(width=RES, height=RES, raster=RasterConfig(**RASTER),
                         shadow_map_size=256)
    ref = np.array(Renderer(scene, cam, cfg, taa=False, bloom=False).render_frame())
    assert_golden_close(port_image, to_u8(ref))


def test_forward_matches_golden(port_image):
    assert_golden_close(port_image, load_png(str(GOLDENS / "forward.png"))[..., :3])


def test_full_post_matches_golden():
    scene, cam = t_build_test_scene(viewport=(RES, RES))
    r = TRenderer(scene, cam, port_cfg(), device="cpu", ssao=True, motion_blur=True)
    img = r.render_frames(3)
    assert r.frame_index == 3 and np.isfinite(img.numpy()).all()
    assert_golden_close(to_u8(img.numpy()), load_png(str(GOLDENS / "full_post.png"))[..., :3])
    ao = r.state["SSAO"].numpy()
    assert ao.min() < 0.95 and ao.max() <= 1.0  # something is occluded


def test_forward_taa_bloom_matches_live_jax_render():
    """Three frames with the camera moved before each of the last two, TAA
    and Bloom on, 96^2. Each frame feeds the next through TAAHistory, so
    per-pass differences (a few 1e-5 in SceneColor, see test_torch_passes)
    carry over with weight 0.9: the LDR images agree to 2e-4 on all but
    0.2 % of values (an exact depth tie between the two rasters picks
    another triangle for a pixel, and TAA's neighbourhood clamp spreads it
    3x3), their means to 1e-5, and TAA's history to 1e-3."""
    from arkoserenderer_tpu.assets.procedural import build_test_scene
    from arkoserenderer_tpu.core.types import RasterConfig
    from arkoserenderer_tpu.models.standard import Renderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig

    res = 96
    jscene, jcam = build_test_scene(viewport=(res, res))
    jr = Renderer(jscene, jcam, PipelineConfig(width=res, height=res, shadow_map_size=128,
                                              raster=RasterConfig(**RASTER)))
    tscene, tcam = t_build_test_scene(viewport=(res, res))
    tr = TRenderer(tscene, tcam, port_cfg(res, 128), device="cpu")
    assert [p.name for p in tr.pipeline.passes] == [p.name for p in jr.pipeline.passes]
    for frame in range(3):
        for cam in (jcam, tcam):
            cam.position = cam.position + np.array([0.15 * frame, 0.0, 0.0], np.float32)
        ref = np.array(jr.render_frame())
        ours = tr.render_frame().numpy()
    assert np.abs(tr.state["SceneVelocity"].numpy()).max() > 1.0  # real motion vectors
    diff = np.abs(ours - ref)
    assert (diff > 2e-4).mean() < 0.002, (diff > 2e-4).mean()
    assert abs(ours.mean() - ref.mean()) < 1e-5
    hist = np.abs(tr.state["TAAHistory"].numpy() - np.asarray(jr.state["TAAHistory"]))
    assert (hist > 1e-3).mean() < 0.002


@pytest.mark.parametrize("name", ["forward", "full_post", "bindless", "test_spot", "translucent"])
def test_bench_frame_kinds_render_on_cpu(name):
    """Each frame kind of the port's bench, built as the bench builds it (at
    a 96^2 config), renders two frames of a moving camera to a finite,
    covered image whose TAA history moves."""
    from arkoserenderer_torch.tools import bench

    cfg = TPipelineConfig(width=96, height=96, raster=TRasterConfig(**RASTER),
                          shadow_map_size=128, local_shadow_map_size=64)
    r = bench.build_renderer(name, small=True, device="cpu", cfg=cfg)
    move = bench.camera_mover(r)
    calls = []
    real = traster.rasterize_tiles
    traster.rasterize_tiles = lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]
    try:
        for _ in range(2):
            move(r.frame_index)
            img = r.render_frame()
            history = r.state["TAAHistory"].clone() if r.frame_index == 1 else history
    finally:
        traster.rasterize_tiles = real
    assert len(calls) == bench.expected_launches(r, 2)
    assert img.shape == (96, 96, 3) and np.isfinite(img.numpy()).all()
    assert r.state["SceneCoverage"].float().mean() > 0.3
    assert (r.state["TAAHistory"] - history).abs().max() > 1e-3
    passes = [p.name for p in r.pipeline.passes]
    assert ("LocalShadow" in passes) == (name == "test_spot")
    assert ("DepthOfField" in passes) == (name in ("full_post", "bindless"))
    if name == "test_spot":
        assert (r.state["ShadowMap.locals"] > 0).float().mean() > 0.2
    if name == "bindless":
        assert len(r.scene.materials) == 66
    assert ("ForwardTranslucent" in passes) == (name == "translucent")


@pytest.mark.parametrize("name", ["forward", "full_post", "rt"])
def test_png_reader_matches_pil(name):
    from PIL import Image

    with Image.open(GOLDENS / f"{name}.png") as im:
        ref = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(load_png(str(GOLDENS / f"{name}.png"))[..., :3], ref)


def test_static_shadow_cache_is_a_host_branch(monkeypatch):
    calls = []
    real = traster.rasterize_tiles

    def counting(*args, **kw):
        calls.append(kw.get("depth_only", False))
        return real(*args, **kw)

    monkeypatch.setattr(traster, "rasterize_tiles", counting)
    scene, cam = t_build_test_scene(viewport=(64, 64))
    r = TRenderer(scene, cam, port_cfg(64, 128), device="cpu", taa=False, bloom=False)
    r.render_frames(3)
    assert calls == [False, True, False, False]   # sun map once, camera per frame
    first = r.state["ShadowMap.sun"]
    r.scene_arrays = r.scene_arrays                 # any scene swap bumps the version
    r.render_frame()
    assert calls[4:] == [False, True]
    assert r.state["ShadowMap.sun"] is not first
    assert r.state["SunShadow.version"] == r.state["scene.version"] == 1
