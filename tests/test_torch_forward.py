"""The port's whole forward slice at 256^2 (the `forward` golden's config,
taa=False, bloom=False) against the live JAX render and the committed
golden, both under the golden test's thresholds (tests/test_golden.py:
mean abs diff < 1.5 and under 0.5 % of pixels off by more than 24, on
uint8 images). Also the static sun-shadow cache's host branch and the
port's PNG reader."""

from pathlib import Path

import numpy as np
import pytest

from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import Renderer as TRenderer
from arkoserenderer_torch.ops import raster as traster
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.utils.imageio import load_png, to_u8

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
