"""Twins of tests/test_truth.py in the port: the path tracer as ground truth
for the raster frame, port against port, at 128^2 under the reference's
thresholds. ``test_direct_lighting_pixelwise`` and
``test_local_lights_pixelwise``: the flat scene, sun only (or a spot and a
point only), no environment, RT shadows, no vignette, against one
``PathTracer(aa=False, max_bounces=1)`` sample: the tracer's first-bounce
NEE is the raster's direct term, so they agree pixel by pixel away from
edges. The textured test's twin is test_torch_truth_textured.py.
"""

import dataclasses

import numpy as np
import torch

from arkoserenderer_torch.assets.procedural import build_flat_test_scene
from arkoserenderer_torch.core.types import RasterConfig
from arkoserenderer_torch.models.pathtracer import PathTracer
from arkoserenderer_torch.models.standard import Renderer
from arkoserenderer_torch.rendering.pipeline import PipelineConfig

torch.set_num_threads(2)

W = H = 128
CFG = PipelineConfig(width=W, height=H,
                     raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                     shadow_map_size=512)


def _edge_mask(img: np.ndarray, thresh: float = 0.03) -> np.ndarray:
    """True where the image is locally smooth (the reference's mask)."""
    lum = img.mean(-1)
    gx = np.abs(np.diff(lum, axis=1, prepend=lum[:, :1]))
    gy = np.abs(np.diff(lum, axis=0, prepend=lum[:1]))
    g = (gx + gy) > thresh
    edge = g.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= np.roll(np.roll(g, dy, 0), dx, 1)
    return ~edge


def _sun_only(scene):
    scene.env_map = np.zeros((1, 2, 3), np.float32)
    scene.env_brightness = 0.0
    scene.ambient_lx = 0.0


def truth_pair(make, seed: int, samples: int = 1, aa: bool = False, res: int = W):
    """(raster LDR, path-traced LDR) at ``res``^2 of the scene ``make()``
    builds: the forward frame with RT shadows and no vignette, and
    ``samples`` one-bounce samples."""
    cfg = dataclasses.replace(CFG, width=res, height=res)
    scene, cam = make()
    raster = Renderer(scene, cam, cfg, device="cpu", rt_shadows=True, taa=False, bloom=False,
                      vignette=0.0).render_frame()
    scene2, cam2 = make()
    tr = PathTracer(scene2, cam2, res, res, max_bounces=1, seed=seed, aa=aa, device="cpu")
    tr.render_sample(samples)
    return raster.cpu().numpy(), tr.ldr().cpu().numpy()


def pixel_rel(raster: np.ndarray, pt: np.ndarray):
    """The reference's per-pixel metric: (smooth mask, relative error)."""
    return _edge_mask(raster), np.abs(pt - raster).max(-1) / (raster.mean(-1) + 0.02)


def test_direct_lighting_pixelwise():
    raster, pt = truth_pair(lambda: build_flat_test_scene(viewport=(W, H)), seed=3)
    mask, rel = pixel_rel(raster, pt)
    assert mask.mean() > 0.7
    assert rel[mask].mean() < 0.01, f"mean rel {rel[mask].mean():.4f}"
    frac_bad = (rel[mask] > 0.05).mean()
    assert frac_bad < 0.015, f"{frac_bad:.2%} of smooth pixels off by >5%"


def local_lights_scene():
    from arkoserenderer_torch.scene.lights import PointLight, SpotLight

    scene, cam = build_flat_test_scene(viewport=(W, H))
    scene.sun = None
    scene.spots.append(SpotLight(
        position=np.array([0.5, 3.5, 1.0], np.float32),
        direction=np.array([-0.15, -1.0, -0.1], np.float32),
        luminous_intensity_cd=220000.0, cast_shadows=True))
    scene.points.append(PointLight(
        position=np.array([-2.0, 2.0, 2.0], np.float32),
        luminous_intensity_cd=90000.0, cast_shadows=True))
    return scene, cam


def test_local_lights_pixelwise():
    raster, pt = truth_pair(local_lights_scene, seed=4)
    assert raster.mean() > 0.01
    mask, rel = pixel_rel(raster, pt)
    assert rel[mask].mean() < 0.04, f"mean rel {rel[mask].mean():.4f}"
    frac_bad = (rel[mask] > 0.05).mean()
    assert frac_bad < 0.02, f"{frac_bad:.2%} of smooth pixels off by >5%"
