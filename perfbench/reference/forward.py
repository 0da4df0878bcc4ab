"""The plain reference of a forward frame: what the port's forward pipeline
computes for a rasterised, sun-shadowed, temporally anti-aliased scene,
written out again in plain PyTorch from the scene's authored host arrays
(``lib/inputs.py``). It imports nothing of the program and shares no code
with it; only the semantics are the same.

A frame, in order:

  animation   the configuration's closed-form instance motion (spin about Y
              and a vertical bob per grid cell), at t = frame * dt
  LOD         an instance draws while the camera's distance to its bounding
              centre lies in its band [near, far)
  transform   object -> world per vertex; world -> clip by the camera's
              jittered view-projection (matrix products: TF32 reaches them)
  near clip   triangles crossing w = near are cut into one or two triangles
              whose corners carry barycentrics of the original
  setup       screen mapping (y down, pixel centres at +0.5), front faces
              counter-clockwise (the sun map keeps both), on-screen boxes
  binning     tiles of the configured size: a triangle whose box spans at
              most ``max_tiles_per_tri`` tiles joins each tile's list,
              ascending by setup row, of which the first ``max_tris_per_tile``
              are kept; larger triangles join one global list every tile
              walks after its own, the first ``max_global_tris`` kept
  raster      edge functions over pixel centres, reverse-Z depth affine in
              screen space, nearest (largest) depth wins, the earlier fragment
              in a tile's walk wins ties
  sun map     the same raster from the sun's orthographic matrix, depth only;
              its variance moments: 2x2 means of d and d*d, then two 3x3 box
              passes with zeros outside
  shading     perspective-correct attributes, trilinear material texture from
              8-bit box-filtered mips (sRGB base colour), the Filament BRDF for
              the sun, a Chebyshev (VSM) shadow with light-bleed reduction,
              motion vectors through last frame's matrices
  compose     diffuse times (SH-2 irradiance of the environment + flat ambient)
  sky         the equirectangular environment where no triangle covers
  bloom       a blur-and-halve pyramid summed back up, 0.04 of it added
  TAA         Catmull-Rom history at the reprojected position, clamped to the
              3x3 neighbourhood, blended 0.1 (1 on frame 0 or off screen)
  output      AgX, vignette 0.18, sRGB

All of it float32, as the configuration states.

``Frame.__init__`` raises ``ValueError`` on a scene or configuration that
uses what this frame does not render: local lights, a sun that casts no
shadow or none, a finite far plane, authored previous transforms, skins,
morphs and clips, materials with more than a base colour (normal,
metal-roughness, emissive or occlusion textures, emissive, double-sided,
clearcoat, subsurface, a blend mode other than opaque), a linear base
colour image, any renderer flag but ``taa`` and ``bloom``, any ``pipeline``
setting. A configuration that uses more names a reference of its own.

Another reference imports these pieces from this file (``from .forward
import ...``: the references load as one package, ``lib/spec.py``), each a
function of tensors with no state:

  the camera  ``CameraModel`` (exposure, jittered reverse-Z projection),
              ``apply``, ``to_screen``
  the scene   ``Scene`` (pool, materials, sun matrix, SH of the environment),
              ``refuse_unrendered``
  raster      ``near_clip``, ``Setup``, ``raster``, ``edge``
  textures    ``MaterialTexture``, ``srgb_to_linear``, ``linear_to_srgb``
  lighting    ``brdf``, ``sun_map`` (with ``vsm_moments``), ``sun_light``
              (with ``vsm_visibility``), ``sh_ambient`` (with ``sh9``,
              ``env_irradiance_sh``), ``sky`` (with ``sample_equirect``)
  post        ``bloom``, ``taa`` (with ``catmull_rom``, ``neighbourhood``),
              ``display`` (AgX, vignette, sRGB)

and ``Frame``'s steps: ``geometry``, ``visibility``, ``surface``."""

from __future__ import annotations

import math
import types

import numpy as np
import torch

F32 = torch.float32
VSM_MIN_VARIANCE = 1e-6
VSM_BLEED = 0.25
TAA_BLEND = 0.1
BLOOM_LEVELS = 5
BLOOM_STRENGTH = 0.04
VIGNETTE = 0.18
PAIR_CHUNK = 8192      # raster fragments are evaluated this many (tile, row) pairs at a time
DEFAULT_TEXTURES = 4   # texture ids 0-3 are the pool's default white, black, flat normal, grey
FLAT_NORMAL = 2
BLEND_OPAQUE = 0


# -- camera and matrices (float64 on the host, rounded to float32) ------------------------

def quat_mat3(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def radical_inverse(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


class CameraModel:
    """The photographic camera: EV100 exposure, a reverse-Z infinite
    perspective with Halton (2, 3) sub-pixel jitter, last frame's matrices."""

    def __init__(self, cam: dict, width: int, height: int):
        self.c = cam
        self.w, self.h = width, height
        ev100 = math.log2(cam["f_number"] ** 2 / cam["shutter_speed"] * 100.0 / cam["iso"])
        self.exposure = float(np.float32(1.0 / (1.2 * 2.0 ** (ev100 - cam["exposure_compensation"]))))

    def view(self, position) -> np.ndarray:
        rot = quat_mat3(self.c["orientation"]).T
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = -rot @ np.asarray(position, np.float64)
        return m.astype(np.float32)

    def proj(self, frame: int | None) -> np.ndarray:
        c = self.c
        half_x = c["sensor_w_mm"] / (2.0 * c["focal_length_mm"])
        fov_y = 2.0 * math.atan(half_x / (self.w / self.h))
        g = 1.0 / math.tan(0.5 * fov_y)
        m = np.array([[g / (self.w / self.h), 0, 0, 0], [0, g, 0, 0], [0, 0, 0, c["near"]],
                      [0, 0, -1, 0]], np.float64)
        if frame is not None and c["jitter"]:
            k = frame % c["jitter_period"] + 1
            jx = float(np.float32(radical_inverse(k, 2)) - np.float32(0.5))
            jy = float(np.float32(radical_inverse(k, 3)) - np.float32(0.5))
            m[0, 2] += -2.0 * jx / self.w
            m[1, 2] += 2.0 * jy / self.h
        return m.astype(np.float32)


def t4(m, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, np.float32), device=device)


def apply(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(4,4) matrix times (N,3) points as (N,4) homogeneous clip: a matrix
    product, so the control's TF32 reaches it."""
    ph = torch.cat([p, torch.ones_like(p[:, :1])], dim=1)
    return ph @ m.T


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-20)


def to_screen(m: torch.Tensor, p: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """(N,2) pixel positions of world points ``p`` under matrix ``m``."""
    c = apply(m, p)
    inv = torch.where(c[:, 3].abs() > 1e-8, 1.0 / c[:, 3], torch.zeros_like(c[:, 3]))
    return torch.stack([(c[:, 0] * inv * 0.5 + 0.5) * w, (0.5 - c[:, 1] * inv * 0.5) * h], -1)


# -- triangles: clip, set up, bin, raster ---------------------------------------------------

def near_clip(clip: torch.Tensor, valid: torch.Tensor, eps: float):
    """(T,3,4) clip corners against w = eps. Returns (clip (R,3,4), bary
    (R,3,3) of each corner in the original triangle, orig (R,), valid (R,)):
    rows 0..T-1 the triangles themselves or their first piece, then the
    second pieces of triangles cut into two, ascending by triangle."""
    t = clip.shape[0]
    dev = clip.device
    inside = clip[..., 3] > eps
    n_in = inside.sum(-1)
    eye = torch.eye(3, device=dev, dtype=F32).expand(t, 3, 3)
    # rotate so that the lone outside corner is last (two inside), or the
    # lone inside corner first (one inside); the winding is kept
    first_out = torch.argmin(inside.to(torch.int8), dim=-1)
    first_in = torch.argmax(inside.to(torch.int8), dim=-1)
    start = torch.where(n_in == 2, (first_out + 1) % 3, first_in)
    idx = (start[:, None] + torch.arange(3, device=dev)[None]) % 3
    rc = torch.gather(clip, 1, idx[..., None].expand(t, 3, 4))
    rb = torch.gather(eye, 1, idx[..., None].expand(t, 3, 3))
    a, b, c = rc[:, 0], rc[:, 1], rc[:, 2]
    ba, bb, bc = rb[:, 0], rb[:, 1], rb[:, 2]

    def cut(p, q, bp, bq):
        dw = q[:, 3] - p[:, 3]
        s = ((eps - p[:, 3]) / torch.where(dw.abs() > 1e-20, dw, torch.ones_like(dw))).clamp(0, 1)
        return p + s[:, None] * (q - p), bp + s[:, None] * (bq - bp)

    i_bc, y_bc = cut(b, c, bb, bc)
    i_ac, y_ac = cut(a, c, ba, bc)
    i_ab, y_ab = cut(a, b, ba, bb)
    two = (n_in == 2)[:, None, None]
    one = (n_in == 1)[:, None, None]
    prim = torch.where(two, torch.stack([a, b, i_bc], 1),
                       torch.where(one, torch.stack([a, i_ab, i_ac], 1), clip))
    prim_b = torch.where(two, torch.stack([ba, bb, y_bc], 1),
                         torch.where(one, torch.stack([ba, y_ab, y_ac], 1), eye))
    # a triangle with one corner outside leaves the quad a, b, i_bc, i_ac:
    # its second piece a, i_bc, i_ac keeps the winding
    extra = torch.nonzero(valid & (n_in == 2)).flatten()
    clip_all = torch.cat([prim, torch.stack([a, i_bc, i_ac], 1)[extra]])
    bary_all = torch.cat([prim_b, torch.stack([ba, y_bc, y_ac], 1)[extra]])
    orig = torch.cat([torch.arange(t, device=dev), extra])
    ok = torch.cat([valid & (n_in > 0), torch.ones_like(extra, dtype=torch.bool)])
    return clip_all, bary_all, orig, ok


def edge(ax, ay, bx, by, px, py):
    """Signed edge function of a -> b at p (positive inside a front face)."""
    return (by - ay) * (px - ax) - (bx - ax) * (py - ay)


class Setup:
    """Screen-space triangles, one per setup row."""

    def __init__(self, clip: torch.Tensor, valid: torch.Tensor, width: int, height: int,
                 cull_back: bool):
        w = clip[..., 3]
        self.inv_w = torch.where(w.abs() > 1e-12, 1.0 / torch.where(w == 0, torch.ones_like(w), w),
                                 torch.zeros_like(w))
        ndc = clip[..., :3] * self.inv_w[..., None]
        self.sx = (ndc[..., 0] * 0.5 + 0.5) * width
        self.sy = (0.5 - ndc[..., 1] * 0.5) * height
        self.z = ndc[..., 2]
        sx, sy = self.sx, self.sy
        area = edge(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2])
        facing = area > 1e-12 if cull_back else area.abs() > 1e-12
        self.x0, self.x1 = sx.min(1).values, sx.max(1).values
        self.y0, self.y1 = sy.min(1).values, sy.max(1).values
        on = (self.x1 >= 0) & (self.y1 >= 0) & (self.x0 < width) & (self.y0 < height)
        self.valid = valid & facing & on
        self.area = area


def raster(s: Setup, width: int, height: int, rc: dict, want_vis: bool):
    """(depth (H,W), row (H,W) or None) under the binning described above."""
    dev = s.sx.device
    th, tw, cap = int(rc["tile_h"]), int(rc["tile_w"]), int(rc["max_tris_per_tile"])
    span_max, global_max = int(rc["max_tiles_per_tri"]), int(rc["max_global_tris"])
    nty, ntx = height // th, width // tw
    r = s.sx.shape[0]
    tx0 = torch.floor(s.x0 / tw).clamp(0, ntx - 1).long()
    tx1 = torch.floor(s.x1 / tw).clamp(0, ntx - 1).long()
    ty0 = torch.floor(s.y0 / th).clamp(0, nty - 1).long()
    ty1 = torch.floor(s.y1 / th).clamp(0, nty - 1).long()
    spx, spy = tx1 - tx0 + 1, ty1 - ty0 + 1
    span = spx * spy
    rows = torch.arange(r, device=dev)

    def pairs(sel):
        """(tile, row) for every tile of each selected row's box."""
        ids = rows[sel]
        n = int(span[ids].max()) if ids.numel() else 0
        k = torch.arange(max(n, 1), device=dev)[None]
        sx_ = spx[ids][:, None]
        tile = (ty0[ids][:, None] + k // sx_) * ntx + tx0[ids][:, None] + k % sx_
        ok = k < span[ids][:, None]
        return tile[ok], ids[:, None].expand_as(tile)[ok]

    lt, lr = pairs(s.valid & (span <= span_max))
    key = lt * r + lr
    key, order = torch.sort(key)
    lt, lr = lt[order], lr[order]
    first = torch.searchsorted(lt, torch.arange(ntx * nty, device=dev))
    rank = torch.arange(lt.numel(), device=dev) - first[lt]
    keep = rank < cap
    lt, lr, rank = lt[keep], lr[keep], rank[keep]
    big = rows[s.valid & (span > span_max)][:global_max]
    gsel = torch.zeros(r, dtype=torch.bool, device=dev)
    gsel[big] = True
    gt, gr = pairs(gsel)
    grank = torch.searchsorted(big, gr) + cap
    tiles = torch.cat([lt, gt])
    rws = torch.cat([lr, gr])
    walk = torch.cat([rank, grank])

    depth = torch.zeros(height * width, dtype=F32, device=dev)
    iy = torch.arange(th, device=dev).repeat_interleave(tw)
    ix = torch.arange(tw, device=dev).repeat(th)
    frags = []
    for c0 in range(0, tiles.numel(), PAIR_CHUNK):
        t_ = tiles[c0:c0 + PAIR_CHUNK]
        w_ = rws[c0:c0 + PAIR_CHUNK]
        gx = (t_ % ntx)[:, None] * tw + ix[None]
        gy = (t_ // ntx)[:, None] * th + iy[None]
        px = gx.to(F32) + 0.5
        py = gy.to(F32) + 0.5
        ax, ay = s.sx[w_, 0:1], s.sy[w_, 0:1]
        bx, by = s.sx[w_, 1:2], s.sy[w_, 1:2]
        cx, cy = s.sx[w_, 2:3], s.sy[w_, 2:3]
        area = s.area[w_, None]
        inv = torch.where(area.abs() > 1e-12, 1.0 / torch.where(area == 0, torch.ones_like(area),
                                                                  area), torch.zeros_like(area))
        l0 = edge(bx, by, cx, cy, px, py) * inv
        l1 = edge(cx, cy, ax, ay, px, py) * inv
        l2 = edge(ax, ay, bx, by, px, py) * inv
        z = s.z[w_]
        d = l0 * z[:, 0:1] + l1 * z[:, 1:2] + l2 * z[:, 2:3]
        cov = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (d > 0) & (d < 2.0)
        pix = (gy * width + gx)[cov]
        dv = d[cov]
        depth.scatter_reduce_(0, pix, dv, reduce="amax")
        if want_vis:
            frags.append((pix, dv, (walk[c0:c0 + PAIR_CHUNK, None].expand_as(d)[cov] * r
                                    + w_[:, None].expand_as(d)[cov])))
    if not want_vis:
        return depth.view(height, width), None
    best = torch.full((height * width,), 2 ** 62, dtype=torch.long, device=dev)
    for pix, dv, k in frags:
        win = dv == depth[pix]
        best.scatter_reduce_(0, pix[win], k[win], reduce="amin")
    row = torch.where(best < 2 ** 62, best % r, torch.full_like(best, -1))
    return depth.view(height, width), row.view(height, width)


# -- textures, BRDF, shadows, environment ---------------------------------------------------

def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = c.clamp_min(0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


class MaterialTexture:
    """A material's base-colour texture: resized to powers of two (at most
    2048), box-filtered mips stored as 8-bit texels, sampled trilinearly
    with repeat (or clamp) addressing; the base colour is sRGB-decoded per
    texel before filtering. A material without one samples white."""

    def __init__(self, img: np.ndarray | None, repeat: bool, device):
        if img is None:
            img = np.full((1, 1, 4), 255, np.uint8)
        h0, w0 = img.shape[:2]
        w, h = (min(1 << max(v - 1, 0).bit_length(), 2048) for v in (w0, h0))
        base = resize_bilinear(img[..., :3].astype(np.float64), w, h)
        levels = [base]
        while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
            cur = levels[-1]
            hh, ww = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
            cur = cur.reshape(hh, cur.shape[0] // hh, ww, cur.shape[1] // ww, 3).mean(axis=(1, 3))
            levels.append(cur)
        levels = levels[:13]
        self.mips = [srgb_to_linear(torch.as_tensor(np.floor(np.clip(m + 0.5, 0, 255)) / 255.0,
                                                    dtype=F32, device=device)) for m in levels]
        self.size = (w, h)
        self.repeat = repeat

    def fetch(self, level: int, uv: torch.Tensor) -> torch.Tensor:
        img = self.mips[level]
        h, w = img.shape[:2]
        x = uv[:, 0] * w - 0.5
        y = uv[:, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        x0, y0 = x0.long(), y0.long()

        def wrap(i, n):
            return torch.remainder(i, n) if self.repeat else i.clamp(0, n - 1)

        out = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                t = img[wrap(y0 + dy, h), wrap(x0 + dx, w)]
                out = out + t * ((fx if dx else 1 - fx) * (fy if dy else 1 - fy))
        return out

    def sample(self, uv, duv_dx, duv_dy):
        size = torch.tensor(self.size, dtype=F32, device=uv.device)
        dx, dy = duv_dx * size, duv_dy * size
        rho2 = torch.maximum((dx * dx).sum(-1), (dy * dy).sum(-1))
        lod = (0.5 * torch.log2(rho2.clamp_min(1e-12))).clamp(0.0, len(self.mips) - 1.0)
        l0 = torch.floor(lod).long()
        l1 = (l0 + 1).clamp_max(len(self.mips) - 1)
        f = (lod - l0.to(F32))[:, None]
        out = torch.zeros(uv.shape[0], 3, dtype=F32, device=uv.device)
        for lv in range(len(self.mips)):
            m0, m1 = l0 == lv, l1 == lv
            if m0.any():
                out[m0] += self.fetch(lv, uv[m0]) * (1 - f[m0])
            if m1.any():
                out[m1] += self.fetch(lv, uv[m1]) * f[m1]
        return out


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    h0, w0 = img.shape[:2]
    if (h0, w0) == (h, w):
        return img
    x = (np.arange(w) + 0.5) * (w0 / w) - 0.5
    y = (np.arange(h) + 0.5) * (h0 / h) - 0.5
    x0 = np.clip(np.floor(x).astype(int), 0, w0 - 1)
    y0 = np.clip(np.floor(y).astype(int), 0, h0 - 1)
    x1, y1 = np.clip(x0 + 1, 0, w0 - 1), np.clip(y0 + 1, 0, h0 - 1)
    fx = np.clip(x - x0, 0, 1)[None, :, None]
    fy = np.clip(y - y0, 0, 1)[:, None, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def brdf(l, v, n, base, rough, metal):
    """Filament's lit surface: GGX, height-correlated Smith, Schlick, Lambert;
    times <n.l>."""
    h = normalize(l + v)
    nv = (n * v).sum(-1, keepdim=True).abs() + 1e-5
    nl = (n * l).sum(-1, keepdim=True).clamp(0, 1)
    nh = (n * h).sum(-1, keepdim=True).clamp(0, 1)
    lh = (l * h).sum(-1, keepdim=True).clamp(0, 1)
    a = rough.clamp_min(0.045) ** 2
    a2 = a * a
    f0 = 0.04 * (1 - metal) + base * metal
    fres = f0 + (1 - f0) * (1 - lh) ** 5
    k = (nh * a2 - nh) * nh + 1
    ndf = a2 / (math.pi * k * k + 1e-20)
    vis = 0.5 / (nl * torch.sqrt((nv - nv * a2) * nv + a2)
                 + nv * torch.sqrt((nl - nl * a2) * nl + a2) + 1e-20)
    return (base * (1 - metal) / math.pi + ndf * vis * fres) * nl


def vsm_moments(depth: torch.Tensor) -> torch.Tensor:
    s = depth.shape[0]
    m = torch.stack([depth, depth * depth])[:, None]         # (2,1,S,S)
    if s % 2 == 0:
        m = torch.nn.functional.avg_pool2d(m, 2)
    box = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=F32, device=depth.device)
    for _ in range(2):
        m = torch.nn.functional.conv2d(m, box, padding=1)
    return m[:, 0].permute(1, 2, 0)                          # (S', S', 2)


def vsm_visibility(mom, sun_vp, wpos, ndl):
    s = mom.shape[0]
    clip = apply(sun_vp, wpos)
    inv_w = 1.0 / clip[:, 3]
    u = clip[:, 0] * inv_w * 0.5 + 0.5
    v = 0.5 - clip[:, 1] * inv_w * 0.5
    slope = torch.sqrt((1 - ndl * ndl).clamp_min(0)) / ndl.clamp_min(0.1)
    d = clip[:, 2] * inv_w + 1.5e-3 + 2.0e-3 * slope.clamp(0, 3)
    x = (u * s - 0.5).clamp(0, s - 1)
    y = (v * s - 0.5).clamp(0, s - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp_max(s - 1), (y0 + 1).clamp_max(s - 1)
    m = ((mom[y0, x0] * (1 - fx) + mom[y0, x1] * fx) * (1 - fy)
         + (mom[y1, x0] * (1 - fx) + mom[y1, x1] * fx) * fy)
    mean = m[:, 0]
    var = (m[:, 1] - mean * mean).clamp_min(VSM_MIN_VARIANCE)
    p = var / (var + (mean - d) ** 2)
    p = ((p - VSM_BLEED) / (1 - VSM_BLEED)).clamp(0, 1)
    lit = torch.where(d >= mean, torch.ones_like(p), p)
    inside = (u > 0) & (u < 1) & (v > 0) & (v < 1)
    return torch.where(inside, lit, torch.ones_like(lit))


def sun_map(sun_vp, wpos, tri, tri_ok, size: int, rc: dict):
    """(depth (S,S), VSM moments) of the sun's depth-only raster of the
    triangles ``tri`` over world vertices ``wpos``, both faces kept."""
    sclip = apply(sun_vp, wpos)[tri]
    sset = Setup(sclip, tri_ok, size, size, cull_back=False)
    depth, _ = raster(sset, size, size, rc, want_vis=False)
    return depth, vsm_moments(depth)


def sun_light(sun_dir, sun_rgb, sun_vp, moments, pos, n, view_dir, base, rough, metal,
              exposure: float):
    """(N,3) the sun's pre-exposed light at surface points, VSM-shadowed."""
    sun_l = -sun_dir[None].expand_as(pos)
    ndl = (n * sun_l).sum(-1).clamp(0, 1)
    shadow = vsm_visibility(moments, sun_vp, pos, ndl)
    return brdf(sun_l, view_dir, n, base, rough, metal) * (sun_rgb * exposure) * shadow[:, None]


def sh9(x, y, z):
    return [torch.full_like(x, 0.282095), 0.488603 * y, 0.488603 * z, 0.488603 * x,
            1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3 * z * z - 1), 1.092548 * x * z,
            0.546274 * (x * x - y * y)]


def env_irradiance_sh(env: torch.Tensor) -> torch.Tensor:
    """(9, 3) SH-2 irradiance of an equirect map (v = 0 up, u wraps at -Z),
    midpoint quadrature over its texels, the cosine lobe folded in."""
    h, w = env.shape[:2]
    th = (torch.arange(h, dtype=F32, device=env.device) + 0.5) / h * math.pi
    ph = ((torch.arange(w, dtype=F32, device=env.device) + 0.5) / w - 0.5) * 2 * math.pi
    st, ct = torch.sin(th)[:, None], torch.cos(th)[:, None]
    x = st * torch.sin(ph)[None]
    y = ct.expand(h, w)
    z = -st * torch.cos(ph)[None]
    dw = st.expand(h, w) * (math.pi / h) * (2 * math.pi / w)
    basis = torch.stack(sh9(x, y, z))
    coeffs = torch.einsum("bhw,hwc->bc", basis * dw[None], env)
    band = torch.tensor([math.pi] + [2 * math.pi / 3] * 3 + [math.pi / 4] * 5, dtype=F32,
                        device=env.device)
    return coeffs * band[:, None]


def sh_ambient(n, sh, env_gain: float, ambient_lx: float, exposure: float):
    """(N,3) pre-exposed irradiance over pi at normals ``n``: the
    environment's SH-2 (clamped at 0) times its brightness, plus the flat
    ambient."""
    x, y, z = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    irr = sum(bs * sh[i][None] for i, bs in enumerate(sh9(x, y, z))).clamp_min(0)
    return (irr * (env_gain / math.pi) + ambient_lx / math.pi) * exposure


def sample_equirect(env, d):
    h, w = env.shape[:2]
    u = torch.atan2(d[:, 0], -d[:, 2]) / (2 * math.pi) + 0.5
    v = torch.acos(d[:, 1].clamp(-1, 1)) / math.pi
    x, y = u * w - 0.5, v * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    xa, xb = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    return ((env[ya, xa] * (1 - fx) + env[ya, xb] * fx) * (1 - fy)
            + (env[yb, xa] * (1 - fx) + env[yb, xb] * fx) * fy)


def sky(env, env_gain: float, exposure: float, j, w: int, h: int, uvp64, pvp, cam_t):
    """(colour (N,3), velocity (N,2)) of the pixels ``j`` (flat indices) that
    no triangle covers: the environment along the unjittered view ray, moved
    as a point 1e4 away."""
    qx = (j % w).to(F32) + 0.5
    qy = (j // w).to(F32) + 0.5
    inv_vp = t4(np.linalg.inv(uvp64), j.device)
    ndc = torch.stack([qx / w * 2 - 1, (0.5 - qy / h) * 2, torch.full_like(qx, 0.5),
                       torch.ones_like(qx)], -1)
    wp = ndc @ inv_vp.T
    dirs = normalize(wp[:, :3] / wp[:, 3:4] - cam_t[None])
    color = sample_equirect(env, dirs) * (env_gain * exposure)
    prev = to_screen(pvp, cam_t[None] + dirs * 1e4, w, h)
    return color, torch.stack([qx, qy], -1) - prev


# -- image post ------------------------------------------------------------------------------

def blur3(img):
    """[1, 2, 1] / 4 along rows then columns, edges clamped. (H, W, C)."""
    p = torch.cat([img[:1], img, img[-1:]], 0)
    img = 0.25 * p[:-2] + 0.5 * p[1:-1] + 0.25 * p[2:]
    p = torch.cat([img[:, :1], img, img[:, -1:]], 1)
    return 0.25 * p[:, :-2] + 0.5 * p[:, 1:-1] + 0.25 * p[:, 2:]


def half(img):
    h, w, c = img.shape
    return img.reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))


def double(img):
    return blur3(img.repeat_interleave(2, 0).repeat_interleave(2, 1))


def bloom(color):
    h, w = color.shape[:2]
    levels = 0
    while levels < BLOOM_LEVELS and h % 2 == 0 and w % 2 == 0 and h > 8 and w > 8:
        h, w, levels = h // 2, w // 2, levels + 1
    if levels == 0:
        return color + BLOOM_STRENGTH * color
    chain = [color]
    for _ in range(levels):
        chain.append(half(blur3(chain[-1])))
    up = chain[-1]
    for i in range(levels - 1, 0, -1):
        up = chain[i] + double(up)
    return color + BLOOM_STRENGTH * double(up)


def catmull_rom(img, x, y):
    h, w = img.shape[:2]
    fx, fy = x - 0.5, y - 0.5
    cx, cy = torch.floor(fx - 0.5) + 0.5, torch.floor(fy - 0.5) + 0.5
    tx, ty = fx - cx, fy - cy

    def weights(t):
        t2, t3 = t * t, t * t * t
        return (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1.0,
                -1.5 * t3 + 2.0 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)

    wx, wy = weights(tx), weights(ty)
    out = 0.0
    for j in range(4):
        yj = (cy + (j - 1)).long().clamp(0, h - 1)
        for i in range(4):
            xi = (cx + (i - 1)).long().clamp(0, w - 1)
            out = out + img[yj, xi] * (wx[i] * wy[j])[:, None]
    return out


def neighbourhood(img):
    p = torch.nn.functional.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")
    lo = -torch.nn.functional.max_pool2d(-p, 3, 1)
    hi = torch.nn.functional.max_pool2d(p, 3, 1)
    return lo[0].permute(1, 2, 0), hi[0].permute(1, 2, 0)


def taa(color, history, velocity, frame: int):
    """(H,W,3) the resolved colour, which is the new history: ``history``
    (None: zeros) by Catmull-Rom at the reprojected position, clamped to
    the 3x3 neighbourhood, blended 0.1 (1 on frame 0 or off screen)."""
    h, w = color.shape[:2]
    dev = color.device
    if history is None:
        history = torch.zeros_like(color)
    gx = (torch.arange(w * h, device=dev) % w).to(F32) + 0.5
    gy = (torch.arange(w * h, device=dev) // w).to(F32) + 0.5
    prx, pry = gx - velocity[:, 0], gy - velocity[:, 1]
    hist = catmull_rom(history, prx, pry).view(h, w, 3)
    lo, hi = neighbourhood(color)
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    onscr = ((prx >= 0) & (prx < w) & (pry >= 0) & (pry < h)).view(h, w, 1)
    alpha = torch.where((frame == 0) | ~onscr, torch.ones_like(hist[..., :1]),
                        torch.full_like(hist[..., :1], TAA_BLEND))
    return hist + (color - hist) * alpha


AGX_IN = [[0.842479062253094, 0.0423282422610123, 0.0423756549057051],
          [0.0784335999999992, 0.878468636469772, 0.0784336],
          [0.0792237451477643, 0.0791661274605434, 0.879142973793104]]
AGX_OUT = [[1.19687900512017, -0.0528968517574562, -0.0529716355144438],
           [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
           [-0.0990297440797205, -0.0989611768448433, 1.15107367264116]]
AGX_MIN_EV, AGX_MAX_EV = -12.47393, 4.026069


def agx(c):
    """The minimal AgX fit (Wrensch / Sobotka), default look."""
    def mat(m, c):
        return torch.stack([c[..., 0] * m[r][0] + c[..., 1] * m[r][1] + c[..., 2] * m[r][2]
                            for r in range(3)], -1)

    v = mat([[np.float32(x) for x in row] for row in AGX_IN], c)
    v = torch.log2(v.clamp_min(1e-10)).clamp(AGX_MIN_EV, AGX_MAX_EV)
    v = (v - AGX_MIN_EV) / (AGX_MAX_EV - AGX_MIN_EV)
    x2 = v * v
    x4 = x2 * x2
    v = (15.5 * x4 * x2 - 40.14 * x4 * v + 31.96 * x4 - 6.868 * x2 * v + 0.4298 * x2
         + 0.1191 * v - 0.00232)
    v = mat([[np.float32(x) for x in row] for row in AGX_OUT], v).clamp(0, 1)
    return v ** 2.2


def display(color):
    """(H,W,3) the displayed image of linear ``color``: AgX, vignette, sRGB."""
    h, w = color.shape[:2]
    dev = color.device
    ldr = agx(color.clamp_min(0))
    uvx = (torch.arange(w, device=dev, dtype=F32) + 0.5) / w
    uvy = (torch.arange(h, device=dev, dtype=F32) + 0.5) / h
    r2 = ((uvx[None] - 0.5) ** 2 + (uvy[:, None] - 0.5) ** 2) * 4.0
    ldr = ldr * (1 - VIGNETTE * r2 * r2).clamp(0, 1)[..., None]
    return linear_to_srgb(ldr).clamp(0, 1)


# -- the scene ---------------------------------------------------------------------------------

def refuse_unrendered(inp: dict, config: dict) -> None:
    """``ValueError`` on what this frame does not render (see the module)."""
    flags = set(config.get("renderer", {})) - {"taa", "bloom"}
    if flags:
        raise ValueError(f"the forward reference has no {sorted(flags)}")
    if config.get("pipeline"):
        raise ValueError("the forward reference renders the default pipeline settings")
    if inp["spots"] or inp["points"]:
        raise ValueError("the reference renders a sun alone")
    if inp["sun"] is None or not inp["sun"]["cast_shadows"]:
        raise ValueError("the reference renders a shadow-casting sun")
    if inp["camera"]["far"] is not None:
        raise ValueError("the reference's projection has an infinite far plane")
    for it in inp["instances"]:
        if it["prev_world"] is not None or it["clip"] is not None:
            raise ValueError("the reference takes instance motion from the animation alone")
    for s in inp["segments"]:
        if s["skeleton"] >= 0 or s["morph_pos"] is not None:
            raise ValueError("the reference has no skinning or morph targets")
    images = inp["images"]
    for m in inp["materials"]:
        if (m["normal_tex"] != FLAT_NORMAL or m["mr_tex"] != 0 or m["emissive_tex"] != 0
                or m["occlusion_tex"] != 0 or m["double_sided"] or m["clearcoat"]
                or m["subsurface"] or np.any(m["emissive_factor"])):
            raise ValueError("the reference's materials have a base colour texture alone")
        if m["blend_mode"] != BLEND_OPAQUE:
            raise ValueError("the reference's materials are opaque")
        tex = m["base_color_tex"]
        if DEFAULT_TEXTURES <= tex < len(images) and not images[tex]["srgb"]:
            raise ValueError("the reference decodes base colour images as sRGB")


class Scene:
    """The pool as the authored instance list lays it out: instance by
    instance, each its segment's vertices and triangles in order."""

    def __init__(self, inp: dict, device):
        self.dev = device
        segs, inst = inp["segments"], inp["instances"]
        pos, nrm, uv, tri, tri_inst, vtx_inst = [], [], [], [], [], []
        base = 0
        for i, it in enumerate(inst):
            s = segs[it["segment"]]
            pos.append(s["positions"])
            nrm.append(s["normals"])
            uv.append(s["uvs"])
            tri.append(s["indices"].reshape(-1, 3) + base)
            tri_inst.append(np.full(len(tri[-1]), i))
            vtx_inst.append(np.full(len(s["positions"]), i))
            base += len(s["positions"])

        def t(a, dtype=F32):
            return torch.as_tensor(np.concatenate(a), dtype=dtype, device=device)

        self.pos, self.nrm, self.uv = t(pos), t(nrm), t(uv)
        self.tri = t(tri, torch.long)
        self.tri_inst = t(tri_inst, torch.long)
        self.vtx_inst = t(vtx_inst, torch.long)
        self.world0 = np.stack([it["world"] for it in inst]).astype(np.float32)
        self.band = torch.as_tensor(np.array([it["lod_band"] for it in inst], np.float32),
                                    device=device)
        self.material = torch.as_tensor([segs[it["segment"]]["material"] for it in inst],
                                        device=device)
        # bounding centres: the box centre of the segment moved by its world
        centres = []
        for it in inst:
            p = segs[it["segment"]]["positions"].astype(np.float64)
            c = 0.5 * (p.min(0) + p.max(0))
            centres.append(it["world"][:3, :3].astype(np.float64) @ c + it["world"][:3, 3])
        self.centre0 = np.array(centres, np.float32)
        self.anim = inp.get("animation")
        self.dt = np.float32(1.0 / 60.0)
        mats = inp["materials"]
        images = inp["images"]
        self.mats = []
        for m in mats:
            tex = m["base_color_tex"]
            tex = tex if DEFAULT_TEXTURES <= tex < len(images) else None
            img = images[tex]["rgba"] if tex is not None else None
            repeat = images[tex]["repeat"] if tex is not None else True
            self.mats.append({
                "factor": torch.tensor(m["base_color_factor"][:3], dtype=F32, device=device),
                "rough": float(m["roughness_factor"]), "metal": float(m["metallic_factor"]),
                "tex": MaterialTexture(img, repeat, device)})
        # the sun's orthographic matrix around the authored scene's bounds
        lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
        for it in inst:
            p = segs[it["segment"]]["positions"].astype(np.float64)
            q = p @ it["world"][:3, :3].astype(np.float64).T + it["world"][:3, 3]
            lo, hi = np.minimum(lo, q.min(0)), np.maximum(hi, q.max(0))
        centre = 0.5 * (lo + hi)
        radius = max(float(np.linalg.norm(hi - centre)), 1e-3)
        sun = inp["sun"]
        d = np.asarray(sun["direction"], np.float64)
        d = d / np.linalg.norm(d)
        self.sun_dir = torch.tensor(d, dtype=F32, device=device)
        self.sun_rgb = torch.tensor(np.asarray(sun["color"], np.float64) * sun["illuminance_lux"],
                                    dtype=F32, device=device)
        up = np.array([0.0, 1.0, 0.0]) if abs(d[1]) <= 0.98 else np.array([1.0, 0.0, 0.0])
        eye = centre - d * radius * 2.0
        f = d
        rr = np.cross(f, up)
        rr /= np.linalg.norm(rr)
        u = np.cross(rr, f)
        view = np.eye(4)
        view[:3, :3] = np.stack([rr, u, -f])
        view[:3, 3] = -view[:3, :3] @ eye
        n, fa = radius * 0.5, radius * 4.0
        proj = np.array([[1 / radius, 0, 0, 0], [0, 1 / radius, 0, 0],
                         [0, 0, 1 / (fa - n), fa / (fa - n)], [0, 0, 0, 1]])
        self.sun_vp = t4(proj @ view, device)
        env = torch.as_tensor(inp["env"]["map"], dtype=F32, device=device)
        self.env = env
        self.env_gain = float(inp["env"]["brightness"])
        self.sh = env_irradiance_sh(env)
        self.ambient_lx = float(inp["env"]["ambient_lx"])

    def transforms(self, frame: int):
        """(world, prev world, normal matrix, bounding centre) per instance at ``frame``."""
        w = torch.as_tensor(self.world0, device=self.dev).clone()
        pw = w.clone()
        nm = torch.linalg.inv(w[:, :3, :3].double()).transpose(1, 2).float()
        centre = torch.as_tensor(self.centre0, device=self.dev).clone()
        a = self.anim
        if a is not None:
            ids = torch.as_tensor(a["instances"], device=self.dev)
            ph = torch.as_tensor(a["phases"], dtype=F32, device=self.dev)
            tx = w[ids, 0, 3].clone()
            tz = w[ids, 2, 3].clone()
            t = np.float32(frame + a["offset"]) * self.dt

            def rows(time):
                ang = time + ph
                c, s = torch.cos(ang), torch.sin(ang)
                bob = 0.8 + 0.35 * torch.sin(2.0 * time + ph)
                m = torch.zeros(len(ids), 4, 4, dtype=F32, device=self.dev)
                m[:, 0, 0], m[:, 0, 2], m[:, 0, 3] = c, s, tx
                m[:, 1, 1], m[:, 1, 3] = 1.0, bob
                m[:, 2, 0], m[:, 2, 2], m[:, 2, 3] = -s, c, tz
                m[:, 3, 3] = 1.0
                return m, bob

            cur, bob = rows(torch.tensor(t, device=self.dev))
            prev, _ = rows(torch.tensor(np.float32(t - self.dt), device=self.dev))
            w[ids], pw[ids] = cur, prev
            nm[ids] = cur[:, :3, :3]
            centre[ids] = torch.stack([tx, bob, tz], -1)
        return w, pw, nm, centre


# -- the frame -----------------------------------------------------------------------------------

class Frame:
    """The configuration's frame from the authored inputs. ``render(frame,
    state)`` takes and returns the persistent state, ``{"TAAHistory":
    (H,W,3)}`` (empty before frame 0, and without TAA), with the compared
    resources."""

    def __init__(self, inp: dict, config: dict, device):
        refuse_unrendered(inp, config)
        self.dev = torch.device(device)
        self.w, self.h = int(config["width"]), int(config["height"])
        self.smap = int(config["shadow_map_size"])
        self.rc = config["raster"]
        flags = config.get("renderer", {})
        self.taa, self.bloom = flags.get("taa", True), flags.get("bloom", True)
        self.scene = Scene(inp, self.dev)
        self.cam = CameraModel(inp["camera"], self.w, self.h)
        self.path = inp["camera_path"]          # frame -> camera position

    def matrices(self, frame: int):
        cam = self.cam
        view = cam.view(self.path(frame))
        prev_view = cam.view(self.path(frame - 1)) if frame > 0 else view
        vp = cam.proj(frame).astype(np.float64) @ view.astype(np.float64)
        uvp = cam.proj(None).astype(np.float64) @ view.astype(np.float64)
        pvp = cam.proj(None).astype(np.float64) @ prev_view.astype(np.float64)
        return (t4(vp, self.dev), t4(uvp, self.dev), t4(pvp, self.dev),
                np.asarray(self.path(frame), np.float32), uvp)

    def geometry(self, frame: int) -> types.SimpleNamespace:
        """The frame's matrices, the instances drawn (LOD) and the world
        vertices now and a frame ago, with their normals."""
        sc, dev = self.scene, self.dev
        vp, uvp, pvp, cam_pos, uvp64 = self.matrices(frame)
        world, pworld, nmat, centre = sc.transforms(frame)
        cam_t = torch.as_tensor(cam_pos, device=dev)
        dist = torch.linalg.norm(centre - cam_t[None], dim=-1)
        drawn = (dist >= sc.band[:, 0]) & (dist < sc.band[:, 1])
        wm = world[sc.vtx_inst]
        wpos = (wm[:, :3, :3] @ sc.pos[:, :, None])[..., 0] + wm[:, :3, 3]
        ppos = (pworld[sc.vtx_inst][:, :3, :3] @ sc.pos[:, :, None])[..., 0] \
            + pworld[sc.vtx_inst][:, :3, 3]
        wnrm = normalize((nmat[sc.vtx_inst] @ sc.nrm[:, :, None])[..., 0])
        return types.SimpleNamespace(frame=frame, vp=vp, uvp=uvp, pvp=pvp, uvp64=uvp64,
                                     cam_t=cam_t, tri_ok=drawn[sc.tri_inst], wpos=wpos,
                                     ppos=ppos, wnrm=wnrm)

    def visibility(self, g) -> types.SimpleNamespace:
        """The camera's raster: depth, each pixel's setup row and scene
        triangle (-1 uncovered), the near-clipped setup and its corners'
        barycentrics in the original triangles."""
        w, h = self.w, self.h
        cclip = apply(g.vp, g.wpos)[self.scene.tri]
        near = float(self.cam.c["near"])
        cclip, cbary, orig, ok = near_clip(cclip, g.tri_ok, near)
        cset = Setup(cclip, ok, w, h, cull_back=True)
        depth, row = raster(cset, w, h, self.rc, want_vis=True)
        row = row.reshape(-1)
        cov = row >= 0
        vis = torch.where(cov, orig[row.clamp_min(0)], torch.full_like(row, -1))
        return types.SimpleNamespace(depth=depth, row=row, cov=cov, vis=vis, orig=orig,
                                     cset=cset, cbary=cbary)

    def surface(self, g, v) -> types.SimpleNamespace:
        """At each covered pixel: world position now and a frame ago, the
        normal, uv and its screen gradients, base colour, roughness and
        metalness from the material."""
        sc, dev, w = self.scene, self.dev, self.w
        rws = v.row[v.cov]
        idx = torch.arange(w * self.h, device=dev)[v.cov]
        px = (idx % w).to(F32) + 0.5
        py = (idx // w).to(F32) + 0.5
        cset = v.cset
        sx, sy, iw = cset.sx[rws], cset.sy[rws], cset.inv_w[rws]

        def bary(qx, qy):
            e = [edge(sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2], qx, qy),
                 edge(sx[:, 2], sy[:, 2], sx[:, 0], sy[:, 0], qx, qy),
                 edge(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], qx, qy)]
            p = torch.stack([e[i] * iw[:, i] for i in range(3)], -1)
            den = p.sum(-1, keepdim=True)
            inv = torch.where(den.abs() > 1e-20, 1.0 / torch.where(den == 0, torch.ones_like(den),
                                                                    den), torch.zeros_like(den))
            return p * inv

        b = bary(px, py)
        bxd = bary(px + 1, py)
        byd = bary(px, py + 1)
        corners = sc.tri[v.orig[rws]]                             # (N,3) vertices
        sub = v.cbary[rws]                                        # (N,3,3)

        def attr(a):
            at = a[corners]                                       # (N,3,C) original corners
            return sub @ at                                       # the cut triangle's corners

        cw, cp, cn, cu = attr(g.wpos), attr(g.ppos), attr(g.wnrm), attr(sc.uv)

        def interp(c, bb):
            return (bb[:, :, None] * c).sum(1)

        pos, prev_pos = interp(cw, b), interp(cp, b)
        n_geo = normalize(interp(cn, b))
        uv = interp(cu, b)
        duv_dx, duv_dy = interp(cu, bxd) - uv, interp(cu, byd) - uv
        mat = sc.material[sc.tri_inst[v.orig[rws]]]
        base = torch.zeros_like(pos)
        rough = torch.zeros_like(pos[:, :1])
        metal = torch.zeros_like(rough)
        for mi, m in enumerate(sc.mats):
            sel = mat == mi
            if sel.any():
                base[sel] = m["tex"].sample(uv[sel], duv_dx[sel], duv_dy[sel]) * m["factor"]
                rough[sel] = min(max(m["rough"], 0.0), 1.0)
                metal[sel] = min(max(m["metal"], 0.0), 1.0)
        return types.SimpleNamespace(pos=pos, prev_pos=prev_pos, n=n_geo, uv=uv, duv_dx=duv_dx,
                                     duv_dy=duv_dy, material=mat, base=base, rough=rough,
                                     metal=metal)

    def render(self, frame: int, state: dict) -> tuple[dict, dict]:
        sc, dev, w, h = self.scene, self.dev, self.w, self.h
        g = self.geometry(frame)
        sun_depth, moments = sun_map(sc.sun_vp, g.wpos, sc.tri, g.tri_ok, self.smap, self.rc)
        v = self.visibility(g)
        s = self.surface(g, v)

        # shading at covered pixels: the sun, then the environment and the flat ambient
        exposure = self.cam.exposure
        view_dir = normalize(g.cam_t[None] - s.pos)
        col = sun_light(sc.sun_dir, sc.sun_rgb, sc.sun_vp, moments, s.pos, s.n, view_dir, s.base,
                        s.rough, s.metal, exposure)
        vel = to_screen(g.uvp, s.pos, w, h) - to_screen(g.pvp, s.prev_pos, w, h)
        col = col + s.base * (1 - s.metal) * sh_ambient(s.n, sc.sh, sc.env_gain, sc.ambient_lx,
                                                        exposure)

        # the sky and its motion where nothing covers
        color = torch.zeros(w * h, 3, dtype=F32, device=dev)
        velocity = torch.zeros(w * h, 2, dtype=F32, device=dev)
        color[v.cov], velocity[v.cov] = col, vel
        bg = ~v.cov
        if bg.any():
            j = torch.arange(w * h, device=dev)[bg]
            color[bg], velocity[bg] = sky(sc.env, sc.env_gain, exposure, j, w, h, g.uvp64, g.pvp,
                                          g.cam_t)
        color = color.view(h, w, 3)
        if self.bloom:
            color = bloom(color)
        written = {}
        if self.taa:
            color = taa(color, state.get("TAAHistory"), velocity, frame)
            written["TAAHistory"] = color
        out = {"Visibility": v.vis.view(h, w), "SceneDepth": v.depth, "ShadowMap.sun": sun_depth,
               "SceneColor": color, "LDR": display(color)}
        return out, written
