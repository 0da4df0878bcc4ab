"""``texture_quality="sorted"`` in the port against the JAX package's:
``ops/texture.sample_bilinear_sorted`` (the reference's tile one-hot gather
behind ``sample_grad(quality="sorted")``) and ``sample_bilinear_tile_onehot``
on a seeded pool of the four default textures and nine more (mipmapped and
not, sRGB and linear, REPEAT and CLAMP) whose last mips end at the pool's
end, so a tile's texel window is clamped back from it as
``lax.dynamic_slice`` clamps it. LODs
span [-1, 8) (past both ends of every chain), uv [-2, 3) (both wrap modes
at work), 4,096 samples (tiles of 256 texels a window: several tiles a
texture, tiles straddling two mips, a mip larger than the window). Held
within 1e-6: both sides round each decoded texel to bfloat16 (the
reference's one-hot matmul), and the 256 decoded sRGB values round alike
in both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.ops import texture as ttx
from arkoserenderer_torch.scene.scene import host_to_device
from arkoserenderer_tpu.ops import texture as jtx

N = 4096
TILE, BUDGET = 256, 256


def _images(rng):
    return [
        (rng.integers(0, 256, (32, 8, 4), dtype=np.uint8), dict(srgb=True)),
        (rng.integers(0, 256, (1, 16, 3), dtype=np.uint8), dict(srgb=False)),
        (rng.integers(0, 256, (8, 1), dtype=np.uint8), dict(srgb=True, wrap=1)),
        (rng.integers(0, 256, (64, 32, 4), dtype=np.uint8), dict(srgb=False, wrap=1)),
        (rng.integers(0, 256, (5, 7, 4), dtype=np.uint8), dict(srgb=True, mipmapped=False)),
        (rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), dict(srgb=True)),
        (rng.integers(0, 256, (16, 16, 4), dtype=np.uint8), dict(srgb=True, wrap=1)),
        (rng.integers(0, 256, (4, 64, 4), dtype=np.uint8), dict(srgb=False)),
        (rng.integers(0, 256, (16, 16, 4), dtype=np.uint8), dict(srgb=True)),
    ]


def _build(pkg, capacity):
    b = pkg.TexturePoolBuilder(max_textures=16, pool_capacity=capacity)
    for img, kw in _images(np.random.default_rng(3)):
        b.add(img, **kw)
    return b


@pytest.fixture(scope="module")
def pools():
    """(JAX pool, port pool), the pool exactly as long as its texels."""
    used = _build(jtx, 1 << 16)._cursor
    jpool = _build(jtx, used).finalize()
    fields = _build(ttx, used).host_fields()
    assert fields["texels"].shape[0] == used >= BUDGET
    second = int(np.asarray(jpool.mip_offset)[12, 1])
    assert second > used - BUDGET  # the last texture's mip 1 window is clamped back
    return jpool, ttx.TexturePool(**{k: host_to_device(v, "cpu") for k, v in fields.items()})


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    tex_id = rng.integers(0, 13, N).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 8.0, N).astype(np.float32)
    lod[::97] = np.nan  # lanes no geometry covers
    return tex_id, uv, lod


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("decode_srgb", [True, False])
def test_sample_bilinear_sorted_matches_jax(pools, decode_srgb):
    jpool, tpool = pools
    tex_id, uv, lod = _inputs(17)
    kw = dict(tile=TILE, texel_budget=BUDGET, decode_srgb=decode_srgb)
    got = ttx.sample_bilinear_sorted(tpool, _t(tex_id), _t(uv), _t(lod), **kw)
    want = jax.jit(functools.partial(jtx.sample_bilinear_sorted, **kw))(
        jpool, jnp.asarray(tex_id), jnp.asarray(uv), jnp.asarray(lod))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert float(got.abs().sum()) > 0.0


def test_tile_onehot_matches_jax(pools):
    """Tile-uniform ids, per-pixel LODs whose tile medians fall between two
    mips (an even count: the mean of the middle two) and windows past the
    budget's reach (taps that contribute 0)."""
    jpool, tpool = pools
    rng = np.random.default_rng(5)
    tex_id = np.repeat(rng.integers(0, 13, N // TILE), TILE).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    lod = np.repeat(rng.integers(-1, 6, N // TILE), TILE).astype(np.float32)
    lod[TILE // 2::TILE] += 1.0  # a tile's median lands on .5 and rounds to even
    got = ttx.sample_bilinear_tile_onehot(tpool, _t(tex_id), _t(uv), _t(lod), tile=TILE,
                                          texel_budget=BUDGET)
    want = jax.jit(functools.partial(jtx.sample_bilinear_tile_onehot, tile=TILE,
                                     texel_budget=BUDGET))(
        jpool, jnp.asarray(tex_id), jnp.asarray(uv), jnp.asarray(lod))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_sample_grad_sorted_matches_jax(pools):
    """``sample_grad(quality="sorted")`` (the default tile and window) from
    screen gradients, as the reference shading mode calls it."""
    jpool, tpool = pools
    tex_id, uv, _ = _inputs(23)
    rng = np.random.default_rng(29)
    scale = np.exp2(rng.uniform(-8.0, 2.0, (N, 1))).astype(np.float32)
    dx = (rng.normal(0, 1, (N, 2)) * scale).astype(np.float32)
    dy = (rng.normal(0, 1, (N, 2)) * scale).astype(np.float32)
    got = ttx.sample_grad(tpool, _t(tex_id), _t(uv), _t(dx), _t(dy), quality="sorted")
    want = jax.jit(functools.partial(jtx.sample_grad, quality="sorted"))(
        jpool, jnp.asarray(tex_id), jnp.asarray(uv), jnp.asarray(dx), jnp.asarray(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
