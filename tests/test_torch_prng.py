"""The device half of ``core/prng`` against ``jax.random``, bit for bit:
``device_key``, ``fold_in`` on a key tensor, ``split`` and ``uniform`` (the
partitionable layout, JAX's default) over several seeds, fold-in values
and shapes, and the host functions on the same keys."""

import jax
import numpy as np
import pytest

from arkoserenderer_torch.core import prng

CASES = [(0, 0), (7, 3), (5, 2**31 + 7), (123456789, 99), (2**31 - 1, 2**32 - 1)]


@pytest.mark.parametrize("seed,data", CASES)
def test_device_threefry_matches_jax(seed, data):
    assert jax.config.jax_threefry_partitionable
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    key = prng.fold_in(prng.device_key(seed, "cpu"), data)
    assert np.array_equal(key.numpy(), np.asarray(jkey).astype(np.int64))
    assert np.array_equal(prng.fold_in(prng.prng_key(seed), data), np.asarray(jkey))
    for n in (2, 4, 7):
        assert np.array_equal(prng.split(key, n).numpy(),
                              np.asarray(jax.random.split(jkey, n)).astype(np.int64))
    k1 = prng.split(key, 4)[1]
    jk1 = jax.random.split(jkey, 4)[1]
    for shape in ((1,), (1000,), (333, 2), (5, 7, 3)):
        got = prng.uniform(k1, shape).numpy()
        want = np.asarray(jax.random.uniform(jk1, shape))
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), shape
        assert (got >= 0).all() and (got < 1).all()


def test_uniform_int_shape_and_host_bits():
    """An int shape is (n,); the words under the float are the host
    ``random_bits``'s."""
    key = prng.fold_in(prng.device_key(3, "cpu"), 11)
    u = prng.uniform(key, 64).numpy()
    bits = prng.random_bits(key.numpy().astype(np.uint32), 64)
    want = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    assert u.shape == (64,) and np.array_equal(u, want)
