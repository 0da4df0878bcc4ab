"""The port's RGBA8 bindless texture pool (``ops/texture``) against the JAX
package's: the pool array for array (texels, offsets, sizes, mip counts,
sRGB flags, wrap modes) on images of every kind (non-square, sides of 1,
an odd-sized one without mips), on the test scene and on the truth
harness's flat scene, and ``sample_trilinear`` at
seeded random uv, LOD and texture ids, to 1e-6 (both sides decode sRGB
with a float32 pow, rounded by two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.ops import texture as ttx
from arkoserenderer_torch.scene.scene import host_to_device
from arkoserenderer_tpu.ops import texture as jtx

FIELDS = ("texels", "mip_offset", "mip_size", "n_mips", "srgb", "wrap")


def _images(rng):
    """Non-square sizes and sides of 1 (the box filter halves each side,
    so a mipmapped side is a power of two, in both packages), RGB, RGBA and
    grey, sRGB or not, REPEAT and CLAMP, and one odd-sized image without
    mips."""
    return [
        (rng.integers(0, 256, (32, 8, 4), dtype=np.uint8), dict(srgb=True)),
        (rng.integers(0, 256, (1, 16, 3), dtype=np.uint8), dict(srgb=False)),
        (rng.integers(0, 256, (8, 1), dtype=np.uint8), dict(srgb=True, wrap=1)),
        (rng.integers(0, 256, (64, 32, 4), dtype=np.uint8), dict(srgb=False, wrap=1)),
        (rng.integers(0, 256, (5, 7, 4), dtype=np.uint8), dict(srgb=True, mipmapped=False)),
        (rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), dict(srgb=True)),
    ]


@pytest.fixture(scope="module")
def pools():
    """The same images through both packages' TexturePoolBuilder: (JAX
    TexturePool, the port's host fields)."""
    rng = np.random.default_rng(3)
    jb = jtx.TexturePoolBuilder(max_textures=16, pool_capacity=1 << 14)
    tb = ttx.TexturePoolBuilder(max_textures=16, pool_capacity=1 << 14)
    for img, kw in _images(rng):
        assert jb.add(img, **kw) == tb.add(img, **kw)
    return jb.finalize(), tb.host_fields()


@pytest.mark.parametrize("field", FIELDS)
def test_pool_matches_jax(pools, field):
    ref, ours = pools
    r, o = np.asarray(getattr(ref, field)), ours[field]
    assert o.dtype == r.dtype and o.shape == r.shape
    np.testing.assert_array_equal(o, r)


def test_scene_pools_match_jax():
    """Scene.build carries the pool: the test scene's (a checkered sRGB
    floor) and the flat scene's (the four defaults alone), with the
    reference's ids."""
    from arkoserenderer_torch.assets import procedural as tproc
    from arkoserenderer_tpu.assets import procedural as jproc

    for name in ("build_test_scene", "build_flat_test_scene"):
        js, _ = getattr(jproc, name)(viewport=(32, 32))
        ts, _ = getattr(tproc, name)(viewport=(32, 32))
        ref = bridge.numpy_fields(js.build().textures)
        ours = bridge.numpy_fields(ts.build("cpu").textures)
        assert set(ours) == set(ref) == set(FIELDS)
        for k in FIELDS:
            o = ours[k].view(np.uint32) if ref[k].dtype == np.uint32 else ours[k]
            np.testing.assert_array_equal(o, ref[k], err_msg=f"{name} {k}")


def test_capacity_errors():
    tb = ttx.TexturePoolBuilder(max_textures=5, pool_capacity=16)
    with pytest.raises(ValueError, match="texel pool"):
        tb.add(np.zeros((4, 4, 4), np.uint8), srgb=False)  # 16 + 4 + 1 texels past 16
    tb.add(np.zeros((2, 2, 4), np.uint8), srgb=False, mipmapped=False)
    with pytest.raises(ValueError, match="texture id"):
        tb.add(np.zeros((1, 1, 4), np.uint8), srgb=False)


@pytest.mark.parametrize("decode_srgb", [True, False])
@pytest.mark.parametrize("pow2", [False, True])
def test_sample_trilinear_matches_jax(pools, decode_srgb, pow2):
    """4,096 seeded samples over every texture, uv in [-2, 3) (both wrap
    modes at work), LOD in [-1, 8) (clamped at both ends); with ``pow2``
    every texture but the odd-sized one (id 8), whose REPEAT is then a
    mask."""
    ref, ours = pools
    tpool = ttx.TexturePool(**{k: host_to_device(v, "cpu") for k, v in ours.items()})
    rng = np.random.default_rng(17)
    n = 4096
    ids = np.array([0, 1, 2, 3, 4, 5, 6, 7, 9]) if pow2 else np.arange(10)
    tex_id = rng.choice(ids, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 8.0, n).astype(np.float32)
    got = ttx.sample_trilinear(tpool, torch.from_numpy(tex_id), torch.from_numpy(uv),
                               torch.from_numpy(lod), decode_srgb=decode_srgb, pow2=pow2)
    want = jtx.sample_trilinear(ref, jnp.asarray(tex_id), jnp.asarray(uv), jnp.asarray(lod),
                                decode_srgb=decode_srgb, pow2=pow2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    zero = ttx.sample_trilinear(tpool, torch.from_numpy(tex_id), torch.from_numpy(uv))
    np.testing.assert_allclose(zero.numpy(), np.asarray(jtx.sample_trilinear(
        ref, jnp.asarray(tex_id), jnp.asarray(uv))), atol=1e-6, rtol=0)
