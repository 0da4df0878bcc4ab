"""Low-discrepancy sequences: Halton for the TAA camera jitter and the SSAO
kernel, the Fibonacci disc for PCF and bokeh taps, the Fibonacci sphere for
probe-ray directions (port of arkoserenderer_tpu/core/halton.py, the parts
the frames use)."""

from __future__ import annotations

import numpy as np


def halton(index: int | np.ndarray, base: int) -> np.ndarray:
    """Radical inverse of ``index`` (1-based) in ``base``; in [0, 1)."""
    index = np.asarray(index, dtype=np.int64)
    result = np.zeros(index.shape, dtype=np.float64)
    f = 1.0
    i = index.copy()
    for _ in range(64):
        if not np.any(i > 0):
            break
        f = f / base
        result = result + f * (i % base)
        i = i // base
    return result


def halton_sequence_2d(count: int, bases: tuple[int, int] = (2, 3)) -> np.ndarray:
    """(count, 2) Halton points in [0, 1)^2, index starting at 1."""
    idx = np.arange(1, count + 1)
    return np.stack([halton(idx, bases[0]), halton(idx, bases[1])], axis=-1)


def camera_jitter_sequence(count: int = 16) -> np.ndarray:
    """(count, 2) sub-pixel jitter offsets in [-0.5, 0.5)^2."""
    return halton_sequence_2d(count).astype(np.float32) - 0.5


def fibonacci_sphere(count: int) -> np.ndarray:
    """(count, 3) near-uniform points on the unit sphere."""
    i = np.arange(count, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / count)
    golden = np.pi * (1.0 + np.sqrt(5.0))
    theta = golden * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=-1,
    ).astype(np.float32)


def fibonacci_disc(count: int) -> np.ndarray:
    """(count, 2) near-uniform points on the unit disc (PCF and bokeh taps)."""
    i = np.arange(count, dtype=np.float64) + 0.5
    r = np.sqrt(i / count)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    theta = golden * i
    return np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1).astype(np.float32)


def r2_sequence(count: int) -> np.ndarray:
    """(count, 2) R2 low-discrepancy points in [0, 1) (the plastic
    constant's additive recurrence, from index 1)."""
    g = 1.32471795724474602596  # plastic constant
    a = np.array([1.0 / g, 1.0 / (g * g)])
    i = np.arange(1, count + 1, dtype=np.float64)[:, None]
    return ((0.5 + a * i) % 1.0).astype(np.float32)
