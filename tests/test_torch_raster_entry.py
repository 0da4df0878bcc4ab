"""The port's whole-raster entry point and its oracle
(``ops/raster.rasterize``, ``ops/raster_reference.rasterize_numpy``) and the
simple hit shader (``ops/rt.shade_hits_simple``) against the JAX package's.

Inputs are seeded numpy clip-space soups (test_torch_raster.py's cases),
handed to both packages as the same arrays.

Tolerances:
  * ``rasterize`` against JAX's ``rasterize``: vis, the bins' ``counts``
    and ``overflow`` and the setup's ``valid`` equal; depth to atol 1e-6 and
    the setup's screen positions to rtol/atol 1e-6 (test_torch_raster.py's
    bounds), since XLA:CPU fuses the edge functions' and the depth sum's
    multiply-adds and eager torch rounds each operation: 214-541 of these
    cases' 4,096 depths differ, by at most 2.8e-8 (on the card the kernel
    equals the plain raster bit for bit: chip_smoke.py phase 24);
  * ``rasterize_numpy``: equal to JAX's bit for bit (the same numpy code);
    against ``rasterize``, tests/test_raster.py's bounds (equal coverage,
    under 0.1 % of ids differing, depth atol 1e-5);
  * ``shade_hits_simple`` on the rt test scene, both shading JAX's hits:
    1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.ops import raster as traster
from arkoserenderer_torch.ops.raster_reference import rasterize_numpy
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.ops import raster as jraster
from arkoserenderer_tpu.ops import raster_reference as jref
from test_torch_raster import H, W, random_scene

torch.set_num_threads(2)

# (name, triangles, cull_backfaces, RasterConfig fields): "overflow" caps
# the lists at 4 triangles a tile, so the bins drop entries.
CASES = [
    ("culled", 40, True, dict(tile_h=8, tile_w=16, max_tris_per_tile=64)),
    ("two_sided", 40, False, dict(tile_h=8, tile_w=16, max_tris_per_tile=64)),
    ("overflow", 60, False, dict(tile_h=8, tile_w=16, max_tris_per_tile=4, max_global_tris=8)),
]


def soup(n):
    clip, idx = random_scene(np.random.default_rng(1234), n)
    return clip, idx, np.ones(len(idx), bool)


@pytest.mark.parametrize("name,n,cull,cfg", CASES, ids=[c[0] for c in CASES])
def test_rasterize_matches_jax(name, n, cull, cfg):
    clip, idx, valid = soup(n)
    jv, jd, js, jb = jraster.rasterize(jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(valid),
                                       width=W, height=H, cfg=JRasterConfig(**cfg),
                                       cull_backfaces=cull)
    tv, td, ts, tb = traster.rasterize(torch.from_numpy(clip), torch.from_numpy(idx),
                                       torch.from_numpy(valid), width=W, height=H,
                                       cfg=TRasterConfig(**cfg), cull_backfaces=cull)
    assert tv.shape == (H, W) and td.shape == (H, W) and tv.dtype == torch.int32
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    assert int(tb.overflow) == int(jb.overflow)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_allclose(ts.screen_xy.numpy(), np.asarray(js.screen_xy), rtol=1e-6,
                               atol=1e-6)
    jv, jd, tv, td = np.asarray(jv), np.asarray(jd), tv.numpy(), td.numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, atol=1e-6)
    assert (td > 0).mean() > 0.1
    assert (int(tb.overflow) > 0) == (name == "overflow")
    if cull:  # culling drops the back faces the two-sided raster draws
        _, d2, _, _ = traster.rasterize(torch.from_numpy(clip), torch.from_numpy(idx),
                                        torch.from_numpy(valid), width=W, height=H,
                                        cfg=TRasterConfig(**cfg), cull_backfaces=False)
        assert (d2.numpy() > 0).sum() > (td > 0).sum()


@pytest.mark.parametrize("cull", [False, True], ids=["two_sided", "culled"])
def test_rasterize_numpy_matches_jax_and_the_raster(cull):
    clip, idx, valid = soup(40)
    valid[::7] = False
    vis, depth = rasterize_numpy(clip, idx, valid, W, H, cull_backfaces=cull)
    j_vis, j_depth = jref.rasterize_numpy(clip, idx, valid, W, H, cull_backfaces=cull)
    np.testing.assert_array_equal(vis, j_vis)
    np.testing.assert_array_equal(depth.view(np.int32), j_depth.view(np.int32))
    # tests/test_raster.py's bounds against the tile raster (w_eps as there).
    tv, td, _, bins = traster.rasterize(
        torch.from_numpy(clip), torch.from_numpy(idx), torch.from_numpy(valid), width=W,
        height=H, cfg=TRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64),
        cull_backfaces=cull)
    assert int(bins.overflow) == 0
    tv, td = tv.numpy(), td.numpy()
    np.testing.assert_array_equal(tv == -1, vis == -1)
    assert (tv != vis).mean() < 0.001
    np.testing.assert_allclose(td, depth, atol=1e-5)
    assert (vis >= 0).mean() > 0.1


def test_shade_hits_simple_matches_jax():
    """The rt golden's scene at 32^2; 512 seeded rays from above it, traced
    by JAX, then shaded by both packages (the port's occlusion rays through
    its own trace_rays) with a DDGI-style ambient, so every term runs."""
    import arkoserenderer_tpu.assets.procedural as jproc
    import arkoserenderer_tpu.scene.lights as jlights
    from arkoserenderer_torch import bridge
    from arkoserenderer_torch.ops.bvh import Hit
    from arkoserenderer_torch.ops.rt import shade_hits_simple
    from arkoserenderer_tpu.ops import rt as jrt
    from test_torch_bvh import j_trace, rt_scene

    js, _ = rt_scene(jproc, jlights, 32)
    ja = js.build(with_bvh=True)
    ta = bridge.scene_arrays_from_numpy(ja._asdict(), "cpu")
    rng = np.random.default_rng(21)
    o = np.concatenate([rng.uniform(-3, 3, (512, 1)), rng.uniform(2, 4, (512, 1)),
                        rng.uniform(-3, 3, (512, 1))], -1).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jhit = j_trace(ja.bvh, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e4), any_hit=False)
    thit = Hit(*(torch.from_numpy(np.array(x)) for x in jhit))
    assert 0.2 < float(thit.hit.float().mean()) < 1.0

    def ambient(p, n):
        return 0.25 + 0.5 * n * n

    ref = np.asarray(jax.jit(lambda s, h, dd: jrt.shade_hits_simple(
        s, h, dd, jnp.float32(0.5), ddgi_sample=ambient))(ja, jhit, jnp.asarray(d)))
    ours = shade_hits_simple(ta, thit, torch.from_numpy(d), 0.5, ddgi_sample=ambient)
    assert ours.shape == (512, 3) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)
    lit = ours.numpy()[thit.hit.numpy()]
    assert lit.std() > 0  # lit and shadowed hits differ
