"""Blue-noise mask generator (void-and-cluster), the counterpart of the
reference's tools/gen_bluenoise.py.

Makes the toroidal 128x128 rank mask of Ulichney's void-and-cluster
algorithm that the port ships as arkoserenderer_torch/assets/data/
bluenoise_128.npy (uint16 ranks; (rank + 0.5) / N**2 is the [0, 1) mask
``ops/noise`` samples). Deterministic for a given seed: a run rewrites the
shipped file with the same bytes.

Usage:
    python -m arkoserenderer_torch.tools.gen_bluenoise
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / "assets" / "data" / "bluenoise_128.npy"


def _energy_kernel(n: int, sigma: float) -> np.ndarray:
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma))


def void_and_cluster(n: int = 128, sigma: float = 1.9, seed: int = 20260818,
                     initial_frac: float = 0.1) -> np.ndarray:
    """(n, n) int32 ranks in [0, n*n): thresholding them at any level gives
    a blue-noise (high-frequency, isotropic) point set."""
    rng = np.random.default_rng(seed)
    total = n * n
    kernel = _energy_kernel(n, sigma)
    kf = np.fft.rfft2(kernel)

    def add_at(energy, y, x, sign):
        energy += sign * np.roll(np.roll(kernel, y, axis=0), x, axis=1)

    m = int(total * initial_frac)
    binary = np.zeros((n, n), bool)
    binary.flat[rng.choice(total, m, replace=False)] = True
    energy = np.fft.irfft2(np.fft.rfft2(binary.astype(np.float64)) * kf, s=(n, n))

    # Relax the initial pattern: move the tightest cluster's point into the
    # largest void until the two are the same pixel.
    for _ in range(total):
        cy, cx = np.unravel_index(np.argmax(np.where(binary, energy, -np.inf)), (n, n))
        binary[cy, cx] = False
        add_at(energy, cy, cx, -1.0)
        vy, vx = np.unravel_index(np.argmin(np.where(binary, np.inf, energy)), (n, n))
        binary[vy, vx] = True
        add_at(energy, vy, vx, +1.0)
        if (vy, vx) == (cy, cx):
            break

    ranks = np.full((n, n), -1, np.int32)
    # Ranks m-1 .. 0: remove the initial points, tightest cluster first.
    b, e = binary.copy(), energy.copy()
    for r in range(m - 1, -1, -1):
        cy, cx = np.unravel_index(np.argmax(np.where(b, e, -np.inf)), (n, n))
        b[cy, cx] = False
        add_at(e, cy, cx, -1.0)
        ranks[cy, cx] = r
    # Ranks m .. total-1: fill the largest void, one pixel at a time.
    b, e = binary.copy(), energy.copy()
    for r in range(m, total):
        vy, vx = np.unravel_index(np.argmin(np.where(b, np.inf, e)), (n, n))
        b[vy, vx] = True
        add_at(e, vy, vx, +1.0)
        ranks[vy, vx] = r

    assert ranks.min() == 0 and ranks.max() == total - 1
    assert len(np.unique(ranks)) == total
    return ranks


def main() -> None:
    ranks = void_and_cluster()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.save(OUT, ranks.astype(np.uint16))
    # Spectral check: blue noise has far less low-frequency energy than high.
    mask = (ranks + 0.5) / ranks.size
    f = np.fft.fftshift(np.abs(np.fft.fft2(mask - mask.mean())))
    n = mask.shape[0]
    yy, xx = np.mgrid[:n, :n]
    rad = np.hypot(yy - n // 2, xx - n // 2)
    ratio = f[rad < n / 8].mean() / f[rad > n / 3].mean()
    print(f"wrote {OUT} ({ranks.shape}, low/high spectral ratio {ratio:.4f}; "
          "blue noise wants << 1)")


if __name__ == "__main__":
    main()
