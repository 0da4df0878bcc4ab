"""JAX's default random-number generator on the host, in numpy.

The reference draws DDGI's per-frame ray rotation with
``jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(7), frame), (4,))``;
the port imports no JAX, so this module computes the same numbers: the
threefry2x32 hash (20 rounds, the key schedule of Salmon et al. 2011, as
``jax._src.prng._threefry2x32_lowering`` writes it), a key as the pair
(seed >> 32, seed & 0xffffffff), ``fold_in`` as the hash of the pair
(0, data), the partitionable bit layout (``jax_threefry_partitionable``,
the default: counter i hashed as the pair (i >> 32, i & 0xffffffff) and
the two output words XOR-ed), and ``normal`` as JAX's float32 transform: a
uniform in [nextafter(-1, 0), 1) from the top 23 bits, then sqrt(2) times
XLA's float32 ``erf_inv`` (Giles' polynomial in w = -log1p(-x^2)).

The keys and the uniforms equal JAX's bit for bit. The normals may differ
by a few ulps: XLA on the CPU evaluates log1p by its own approximation and
contracts the polynomial's multiply-adds into FMAs; here log1p is rounded
once from float64 and each multiply-add is rounded once, as an FMA is.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 coefficients, highest degree first, for w < 5 and w >= 5.
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                          1.50140941], np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                          2.83297682], np.float32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the counter pairs (x0, x1) under ``key`` (a
    pair of uint32); arrays of uint32 in, the two output words out."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two words."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([a, b])


def random_bits(key, n: int) -> np.ndarray:
    """n uint32 words, the partitionable layout of ``jax.random.bits``."""
    count = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32(key, (count >> np.uint64(32)).astype(np.uint32),
                        (count & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return a ^ b


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: Giles' polynomial, in float32 with each
    multiply-add rounded once."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, cs, cl).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(np.float32)
    edge = np.abs(x) == np.float32(1.0)
    return np.where(edge, x * np.finfo(np.float32).max, p * x).astype(np.float32)


def normal(key, n: int) -> np.ndarray:
    """``jax.random.normal(key, (n,))`` in float32."""
    bits = random_bits(key, n)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)


def ddgi_rotation_normals(frame_index: int) -> np.ndarray:
    """The four normals DDGI's probe update draws in frame ``frame_index``:
    ``normal(fold_in(PRNGKey(7), frame_index), (4,))``."""
    return normal(fold_in(prng_key(7), frame_index), 4)
