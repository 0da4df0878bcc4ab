"""The port's image helpers (ops/image.py) against the JAX package's, function
against function, on seeded random 37x53x3 and 64x64x3 images and random
coordinates, a fifth of them off the image.

Tolerance: rtol 1e-5, atol 1e-6 (both sides are f32; XLA:CPU may fuse a
multiply-add that eager torch rounds twice, and sums a window in another
order). The 3x3 min/max, the static shift and the nearest-depth upsample
move values without arithmetic and are equal. The reduced-rate helpers:
``bilinear_sample_small_offset`` at 96^2 on values in [0, 4) and offsets
up to a pixel within 2e-6 (a few ulps); ``upsample_bilinear_k`` at k = 1
to 4, with and without halo rows, within 1e-6 (the JAX side of these
jitted: one compile, not one per operation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.ops import image as timg
from arkoserenderer_tpu.ops import image as jimg
from arkoserenderer_tpu.ops.postprocess import shift_img as j_shift_img

SHAPES = [(37, 53, 3), (64, 64, 3)]


def image(shape, seed=0):
    return np.random.default_rng(seed).lognormal(-1.0, 1.0, size=shape).astype(np.float32)


def coords(shape, n=4096, seed=1):
    """Pixel-centre based sample positions; about a fifth lie off the image,
    and the first ones sit exactly on texel centres and borders."""
    h, w = shape[0], shape[1]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1 * w, 1.1 * w, n).astype(np.float32)
    y = rng.uniform(-0.1 * h, 1.1 * h, n).astype(np.float32)
    x[:8] = [0.0, 0.5, 1.0, w - 0.5, w, w + 3.0, -3.0, 1.5]
    y[:8] = [0.0, 0.5, 1.0, h - 0.5, h, h + 3.0, -3.0, 1.5]
    return x, y


def close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["bilinear_sample", "sample_catmull_rom"])
def test_resampling_matches_jax(name, shape):
    img = image(shape)
    x, y = coords(shape)
    ours = getattr(timg, name)(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    ref = getattr(jimg, name)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    assert ours.shape == (len(x), 3)
    close(ours, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["blur3", "upsample2x", "luminance"])
def test_stencils_match_jax(name, shape):
    img = image(shape, seed=2)
    close(getattr(timg, name)(torch.from_numpy(img)), getattr(jimg, name)(jnp.asarray(img)))


def test_downsample2x_matches_jax():
    for shape in [(36, 52, 3), (64, 64, 3)]:  # H and W must be even
        img = image(shape, seed=3)
        ours = timg.downsample2x(torch.from_numpy(img))
        assert ours.shape == (shape[0] // 2, shape[1] // 2, 3)
        close(ours, jimg.downsample2x(jnp.asarray(img)))


@pytest.mark.parametrize("shape", SHAPES)
def test_neighborhood_min_max_equals_jax(shape):
    """Equal, border rows and columns included: the reference's windows
    start from +-inf under SAME padding, the port's pooling pads with -inf;
    both are edge clamp."""
    img = image(shape, seed=4)
    lo, hi = timg.neighborhood_min_max(torch.from_numpy(img))
    jlo, jhi = jimg.neighborhood_min_max(jnp.asarray(img))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert np.isfinite(lo.numpy()).all() and np.isfinite(hi.numpy()).all()
    assert lo[0, 0, 0] == img[:2, :2, 0].min() and hi[-1, -1, 2] == img[-2:, -2:, 2].max()


@pytest.mark.parametrize("shift", [(-1, 0), (1, 0), (0, 1), (0, -1), (2, -3), (0, 0)])
def test_shift_img_equals_jax(shift):
    img = image((37, 53, 3), seed=5)
    for arr in (img, img[..., 0]):  # (H, W, C) and (H, W)
        ours = timg.shift_img(torch.from_numpy(arr), *shift)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(j_shift_img(jnp.asarray(arr), *shift)))


@pytest.mark.parametrize("limit", [0.3, 1.0])
def test_bilinear_sample_small_offset_matches_jax(limit):
    """Nine weighted shifts, summed in the reference's order; and, a
    different rounding of the same filter, within 1e-4 of the gather."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 4.0, (96, 96, 3)).astype(np.float32)
    ox, oy = (rng.uniform(-limit, limit, (96, 96)).astype(np.float32) for _ in range(2))
    ours = timg.bilinear_sample_small_offset(*map(torch.from_numpy, (img, ox, oy)))
    ref = jax.jit(jimg.bilinear_sample_small_offset)(*map(jnp.asarray, (img, ox, oy)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=2e-6)
    px, py = (g + 0.5 for g in np.meshgrid(np.arange(96), np.arange(96)))
    gathered = timg.bilinear_sample(torch.from_numpy(img),
                                    torch.from_numpy((px + ox).ravel().astype(np.float32)),
                                    torch.from_numpy((py + oy).ravel().astype(np.float32)))
    np.testing.assert_allclose(ours.numpy().reshape(-1, 3), gathered.numpy(), atol=1e-4)


@pytest.mark.parametrize("shape", [(24, 20, 3), (5, 7, 1)])
def test_upsample_nearest_depth_equals_jax(shape):
    """Half-rate values to full rate by nearest depth; ties (equal depths,
    from a coarse grid of depth values) keep the first candidate."""
    rng = np.random.default_rng(8)
    h, w, c = shape
    half = rng.standard_normal(shape).astype(np.float32)
    half_depth = (rng.integers(0, 4, (h, w)) / 4).astype(np.float32)
    full_depth = (rng.integers(0, 8, (2 * h, 2 * w)) / 8).astype(np.float32)
    ours = timg.upsample_nearest_depth(*map(torch.from_numpy, (half, half_depth, full_depth)))
    ref = jax.jit(jimg.upsample_nearest_depth)(*map(jnp.asarray,
                                                    (half, half_depth, full_depth)))
    assert ours.shape == (2 * h, 2 * w, c)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k,halo", [(1, False), (2, False), (2, True), (3, True), (4, False)])
def test_upsample_bilinear_k_matches_jax(k, halo):
    rng = np.random.default_rng(9 + k)
    img = rng.uniform(0.0, 4.0, (6, 9, 3)).astype(np.float32)
    rows = tuple(rng.uniform(0.0, 4.0, (1, 9, 3)).astype(np.float32) for _ in range(2))
    ours = timg.upsample_bilinear_k(torch.from_numpy(img), k,
                                    tuple(map(torch.from_numpy, rows)) if halo else None)
    ref = jax.jit(jimg.upsample_bilinear_k, static_argnums=1)(
        jnp.asarray(img), k, tuple(map(jnp.asarray, rows)) if halo else None)
    assert ours.shape == (6 * k, 9 * k, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
