"""Image-space helpers: bilinear and Catmull-Rom resampling, the sub-pixel
shift resample, the 2x pyramid steps, 3x3 stencils, the rational-ratio
resizes and the reduced-rate upsamplers (port of
arkoserenderer_tpu/ops/image.py, the functions the post chain, the
upscalers and the reduced-rate passes use: TAA reprojection, the bloom
pyramid, depth of field, motion blur, spatial and temporal upscaling, the
half-rate RT and DDGI reconstruction and the low-rate sky fetch). All take
(H, W, C) images and run as plain tensor ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def clamped_index(v: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """trunc(v) + offset clipped to [0, n - 1], as int64. ``v`` is clamped to
    [-2, n + 1] first so the cast never leaves the integer range; the clip
    gives the same index either way."""
    return torch.clamp(torch.clamp(v, -2.0, n + 1.0).to(torch.int64) + offset, 0, n - 1)


def bilinear_sample_many(imgs, x: torch.Tensor, y: torch.Tensor) -> list[torch.Tensor]:
    """``bilinear_sample`` of several (H, W, C_i) images of one size at the
    same coordinates: the tap indices and weights are formed once.

    Fetch images apart rather than concatenated to 4 channels: torch gathers
    rows of 16 bytes with another kernel, which took 1.25 ms for 2.07 M rows
    of 4 floats against 0.05 ms for rows of 3 and 0.07 ms for rows of 5
    (one H100 80GB HBM3, 700 W)."""
    h, w = imgs[0].shape[0], imgs[0].shape[1]
    fx = x - 0.5
    fy = y - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0i = clamped_index(x0, w)
    x1i = clamped_index(x0, w, 1)
    y0w = clamped_index(y0, h) * w
    y1w = clamped_index(y0, h, 1) * w
    i00, i10, i01, i11 = y0w + x0i, y0w + x1i, y1w + x0i, y1w + x1i
    out = []
    for img in imgs:
        flat = img.reshape(-1, img.shape[-1])
        top = flat[i00] * (1 - tx) + flat[i10] * tx
        bot = flat[i01] * (1 - tx) + flat[i11] * tx
        out.append(top * (1 - ty) + bot * ty)
    return out


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (H, W, C) at float pixel coordinates ((N,) x and y, pixel-centre
    based: x = 0.5 is texel 0's centre). Clamp addressing. Returns (N, C)."""
    return bilinear_sample_many((img,), x, y)[0]


def _as_planes(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> a (1, C, H, W) view for the pooling functions."""
    return img.permute(2, 0, 1)[None]


def _from_planes(planes: torch.Tensor) -> torch.Tensor:
    return planes[0].permute(1, 2, 0)


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 box downsample (the block sum times 0.25); H and W even."""
    return _from_planes(F.avg_pool2d(_as_planes(img), 2, stride=2, divisor_override=1)) * 0.25


def shift_img(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped static shift of the first two axes:
    out[y, x] = img[clamp(y + dy), clamp(x + dx)]."""

    def along(a, d, axis):
        if d == 0:
            return a
        n = a.shape[axis]
        edge = a.narrow(axis, 0 if d < 0 else n - 1, 1)
        pad = edge.repeat_interleave(min(abs(d), n), dim=axis)
        keep = a.narrow(axis, 0, max(n - abs(d), 0)) if d < 0 else a.narrow(
            axis, min(d, n), max(n - d, 0))
        return torch.cat([pad, keep] if d < 0 else [keep, pad], dim=axis)

    return along(along(img, dy, 0), dx, 1)


def blur3(img: torch.Tensor, halo_rows=None) -> torch.Tensor:
    """3x3 binomial ([1, 2, 1] / 4, separable) blur with edge clamp.

    ``halo_rows``: optional (top, bottom) single rows of the neighbouring
    bands (``band_halo_rows``) in place of the row axis's edge clamp, so
    the stencil is seam-exact under pixel-band sharding."""

    def conv_axis(x, axis):
        n = x.shape[axis]
        if axis == 0 and halo_rows is not None:
            p = torch.cat([halo_rows[0], x, halo_rows[1]], dim=0)
        else:
            p = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], dim=axis)
        return (0.25 * p.narrow(axis, 0, n) + 0.5 * p.narrow(axis, 1, n)
                + 0.25 * p.narrow(axis, 2, n))

    return conv_axis(conv_axis(img, 0), 1)


def upsample2x(img: torch.Tensor, halo_rows=None) -> torch.Tensor:
    """2x nearest upsample followed by the 3x3 binomial blur. ``halo_rows``
    are the neighbouring bands' coarse rows (``band_halo_rows``): after the
    repeat, the row next to the band's edge is the neighbour's coarse
    boundary row."""
    if halo_rows is not None:
        halo_rows = tuple(r.repeat_interleave(2, dim=1) for r in halo_rows)
    return blur3(img.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1), halo_rows)


def upsample_bilinear_k(img: torch.Tensor, k: int, halo_rows=None) -> torch.Tensor:
    """(h, w, c) -> (h * k, w * k, c) separable bilinear upsample with edge
    clamp: each axis edge-padded by one (the rows from ``halo_rows``, the
    neighbouring bands' rows of ``band_halo_rows``, in place of the row
    clamp), then for each of the k output phases the lerp of two
    neighbouring slices at f = (phase + 0.5) / k - 0.5, interleaved."""
    if k == 1:
        return img

    def axis_up(x, axis):
        n = x.shape[axis]
        if axis == 0 and halo_rows is not None:
            p = torch.cat([halo_rows[0], x, halo_rows[1]], dim=0)
        else:
            p = _edge_pad(x, axis, 1)
        prev, cur, nxt = p.narrow(axis, 0, n), p.narrow(axis, 1, n), p.narrow(axis, 2, n)
        phases = []
        for ph in range(k):
            f = (ph + 0.5) / k - 0.5
            if f < 0:
                phases.append(cur * (1.0 + f) + prev * (-f))
            else:
                phases.append(cur * (1.0 - f) + nxt * f)
        return _interleave(phases, x, n * k, axis)

    return axis_up(axis_up(img, 0), 1)


def band_halo_rows(img: torch.Tensor, band) -> tuple[torch.Tensor, torch.Tensor]:
    """(top, bottom): the last row of the band above and the first row of
    the band below this rank's band ``img``, for seam-exact banded
    stencils. One all_gather of every band's first and last row over
    ``band`` (a ``parallel.sharded.BandGroup``); the frame's first and last
    bands keep their own edge row, the edge clamp of the whole frame."""
    parts = band.all_gather(torch.cat([img[:1], img[-1:]]))
    top = img[:1] if band.rank == 0 else parts[band.rank - 1][1:2]
    bottom = img[-1:] if band.rank == band.size - 1 else parts[band.rank + 1][0:1]
    return top, bottom


def neighborhood_min_max(img: torch.Tensor):
    """Per-pixel 3x3 min and max; windows are cut at the border (the pooling
    pads with -inf, which never wins), which equals edge clamp."""
    planes = _as_planes(img)
    hi = F.max_pool2d(planes, 3, stride=1, padding=1)
    lo = -F.max_pool2d(-planes, 3, stride=1, padding=1)
    return _from_planes(lo), _from_planes(hi)


def sample_catmull_rom(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """16-tap Catmull-Rom resampling at pixel-centre coordinates (sharper TAA
    history than bilinear). Each tap index is cast to an integer before it is
    clipped, so negative coordinates truncate toward zero first."""
    h, w = img.shape[0], img.shape[1]
    fx = x - 0.5
    fy = y - 0.5
    cx = torch.floor(fx - 0.5) + 0.5  # centre tap
    cy = torch.floor(fy - 0.5) + 0.5
    tx = fx - cx
    ty = fy - cy

    def weights(t):
        t2 = t * t
        t3 = t2 * t
        return (-0.5 * t3 + t2 - 0.5 * t,
                1.5 * t3 - 2.5 * t2 + 1.0,
                -1.5 * t3 + 2.0 * t2 + 0.5 * t,
                0.5 * t3 - 0.5 * t2)

    wx = weights(tx)
    wy = weights(ty)
    flat = img.reshape(-1, img.shape[-1])
    cols = [clamped_index(cx + (i - 1), w) for i in range(4)]
    acc = 0.0
    for j, wyj in enumerate(wy):
        row = clamped_index(cy + (j - 1), h) * w
        for i, wxi in enumerate(wx):
            acc = acc + flat[row + cols[i]] * (wxi * wyj)[:, None]
    return acc


def _edge_pad(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``x`` with its first and last slices along ``axis`` repeated ``n``
    times on either side."""
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, x.shape[axis] - 1, 1)
    return torch.cat([first] * n + [x] + [last] * n, dim=axis)


def _phases(x: torch.Tensor, out_n: int, axis: int, pad: int):
    """For ``out_n = in_n * k / m`` in lowest terms along ``axis``: (k, m,
    ``strided``), where ``strided(start, count)`` takes the ``count`` input
    slices start, start + m, ... of the input edge-padded by ``pad``."""
    in_n = x.shape[axis]
    g = math.gcd(out_n, in_n)
    k, m = out_n // g, in_n // g
    if k > 16:
        raise ValueError(f"resize {in_n}->{out_n}: {k} phases; pick sizes of a small "
                         "rational ratio")
    padded = _edge_pad(x, axis, pad)

    def strided(start: int, count: int) -> torch.Tensor:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start + pad, start + pad + (count - 1) * m + 1, m)
        return padded[tuple(idx)]

    return k, m, strided


def _interleave(phases: list[torch.Tensor], x: torch.Tensor, out_n: int,
                axis: int) -> torch.Tensor:
    """Phase p's slice t becomes output index t * k + p along ``axis``."""
    shape = list(x.shape)
    shape[axis] = out_n
    return torch.stack(phases, dim=axis + 1).reshape(shape)


def resize_bilinear_rational(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(h, w, c) -> (out_h, out_w, c) bilinear resample (pixel-centre
    aligned, edge clamp) for sizes of a small rational ratio: output rows of
    one phase read input rows at a fixed stride, so every phase is the lerp
    of two strided slices with a constant weight."""

    def axis_resize(x, out_n, axis):
        if out_n == x.shape[axis]:
            return x
        k, m, strided = _phases(x, out_n, axis, 1)
        phases = []
        for p in range(k):
            y = (p + 0.5) * m / k - 0.5
            y0 = math.floor(y)
            f = y - y0
            lo = strided(max(y0, -1), out_n // k)
            hi = strided(max(y0, -1) + 1, out_n // k)
            phases.append(lo * (1.0 - f) + hi * f)
        return _interleave(phases, x, out_n, axis)

    return axis_resize(axis_resize(img, out_h, 0), out_w, 1)


def resize_bilinear_rational_jittered(img: torch.Tensor, out_h: int, out_w: int,
                                      jitter_x: torch.Tensor,
                                      jitter_y: torch.Tensor) -> torch.Tensor:
    """The rational resample of an image rendered with a sub-pixel camera
    jitter of (+jitter_x, +jitter_y) pixels (|j| <= 0.5; 0-dim tensors):
    input sample i holds the scene at i - j, so the scene at y is read at
    y + j. Each output phase is four strided slices weighted by the
    triangle kernel at the jittered offset (two weights are nonzero). An
    axis of equal size is still shifted by its jitter."""

    def axis_resize(x, out_n, axis, j):
        k, m, strided = _phases(x, out_n, axis, 2)
        phases = []
        for p in range(k):
            y0 = (p + 0.5) * m / k - 0.5
            base = math.floor(y0)
            yrel = j + (y0 - base)  # in [-0.5, 1.5)
            acc = None
            for t in (-1, 0, 1, 2):
                wt = torch.clamp(1.0 - torch.abs(yrel - t), min=0.0)
                sl = strided(base + t, out_n // k) * wt
                acc = sl if acc is None else acc + sl
            phases.append(acc)
        return _interleave(phases, x, out_n, axis)

    return axis_resize(axis_resize(img, out_h, 0, jitter_y), out_w, 1, jitter_x)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec. 709 luma of (..., 3) colours, keeping a last axis of 1."""
    return rgb[..., 0:1] * 0.2126 + rgb[..., 1:2] * 0.7152 + rgb[..., 2:3] * 0.0722


def bilinear_sample_small_offset(img: torch.Tensor, ox: torch.Tensor,
                                 oy: torch.Tensor) -> torch.Tensor:
    """Bilinear resample of (H, W, C) at (x + ox, y + oy) for per-pixel
    offsets ``ox``, ``oy`` (H, W) of at most a pixel, edge-clamped like
    ``bilinear_sample``, without a gather: nine edge-clamped static shifts,
    each weighted by the separable triangle kernel at the offset, summed
    row shift by row shift (-1, 0, 1), column shift by column shift within
    each, from zeros."""
    out = torch.zeros_like(img)
    axo = ox[..., None]
    ayo = oy[..., None]
    for sy in (-1, 0, 1):
        wy = torch.clamp(1.0 - torch.abs(sy - ayo), min=0.0)
        for sx in (-1, 0, 1):
            wx = torch.clamp(1.0 - torch.abs(sx - axo), min=0.0)
            out = out + shift_img(img, sy, sx) * (wx * wy)
    return out


def upsample_nearest_depth(half_img: torch.Tensor, half_depth: torch.Tensor,
                           full_depth: torch.Tensor) -> torch.Tensor:
    """(H/2, W/2, C) values -> (H, W, C) by nearest depth: each full pixel
    takes, of the four half-res cells (0, 0), (0, 1), (1, 0) and (1, 1)
    from its own (edge-clamped), the first whose depth is strictly closest
    to its own (no value leaks across a silhouette)."""

    def up(a):
        return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)

    best = best_err = None
    for dy in (0, 1):
        for dx in (0, 1):
            cand = up(shift_img(half_img, dy, dx))
            err = torch.abs(up(shift_img(half_depth[..., None], dy, dx))[..., 0] - full_depth)
            if best is None:
                best, best_err = cand, err
            else:
                best = torch.where((err < best_err)[..., None], cand, best)
                best_err = torch.minimum(best_err, err)
    return best
