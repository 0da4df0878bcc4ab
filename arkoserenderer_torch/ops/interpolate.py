"""Visibility-buffer attribute reconstruction (port of
arkoserenderer_tpu/ops/interpolate.py).

From the raster's per-pixel setup-row ids, rebuild the perspective-correct
barycentrics at each pixel centre, and at +1 px in x and in y for the
analytic derivatives the texture LOD needs, then interpolate vertex
attributes. A near-clipped sub-triangle's barycentrics are mapped to its
original triangle through the setup's ``corner_bary``, so shading never
sees the clip. Every function works on flattened pixels (N = H * W).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from arkoserenderer_torch.ops.raster import TriSetup, edge_fn


class PixelGeom(NamedTuple):
    """Per-pixel interpolation data, all (N, ...)."""

    tri: torch.Tensor      # (N,) i64 original triangle id (row 0's for background)
    valid: torch.Tensor    # (N,) bool: covered by geometry
    corners: torch.Tensor  # (N, 3) i64 vertex indices of the original triangle
    bary: torch.Tensor     # (N, 3) perspective-correct original barycentrics
    bary_dx: torch.Tensor  # (N, 3) the barycentrics at +1 px in x
    bary_dy: torch.Tensor  # (N, 3) the barycentrics at +1 px in y


def _persp_bary(sxy: torch.Tensor, inv_w: torch.Tensor, px, py) -> torch.Tensor:
    """Perspective-correct barycentrics of pixel (px, py) w.r.t. triangle
    screen corners sxy (N,3,2) with per-corner 1/w (N,3) -> (N,3).
    Guarded: weights summing to zero give zeros, not inf/NaN."""
    x, y = sxy[..., 0], sxy[..., 1]
    e0 = edge_fn(x[:, 1], y[:, 1], x[:, 2], y[:, 2], px, py)
    e1 = edge_fn(x[:, 2], y[:, 2], x[:, 0], y[:, 0], px, py)
    e2 = edge_fn(x[:, 0], y[:, 0], x[:, 1], y[:, 1], px, py)
    pw = torch.stack([e0, e1, e2], dim=-1) * inv_w
    den = torch.sum(pw, dim=-1, keepdim=True)
    return pw * torch.where(torch.abs(den) > 1e-20, 1.0 / torch.where(den == 0, 1.0, den), 0.0)


def pixel_barycentrics(vis_flat: torch.Tensor, setup: TriSetup, indices: torch.Tensor,
                       px: torch.Tensor, py: torch.Tensor) -> PixelGeom:
    """``vis_flat``: (N,) setup-row ids (VIS_NONE background); ``px``,
    ``py``: (N,) pixel centres; ``indices``: the scene's (T, 3) triangle
    pool. A background pixel reads setup row 0, so every gather stays in
    bounds; its values are masked by ``valid`` downstream."""
    valid = vis_flat >= 0
    row = torch.clamp(vis_flat, min=0).long()
    sxy = setup.screen_xy[row]        # (N, 3, 2)
    inv_w = setup.inv_w[row]          # (N, 3)
    orig = setup.orig_tri[row].long()
    cb = setup.corner_bary[row]       # (N, 3, 3): rows are the corners' barycentrics
    corners = indices[orig].long()

    def to_orig(sub):
        return sub[:, 0:1] * cb[:, 0] + sub[:, 1:2] * cb[:, 1] + sub[:, 2:3] * cb[:, 2]

    return PixelGeom(
        tri=orig, valid=valid, corners=corners,
        bary=to_orig(_persp_bary(sxy, inv_w, px, py)),
        bary_dx=to_orig(_persp_bary(sxy, inv_w, px + 1.0, py)),
        bary_dy=to_orig(_persp_bary(sxy, inv_w, px, py + 1.0)),
    )


def _weigh(bary: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return bary[:, 0:1] * vals[:, 0] + bary[:, 1:2] * vals[:, 1] + bary[:, 2:3] * vals[:, 2]


def interpolate(attr: torch.Tensor, geom: PixelGeom) -> torch.Tensor:
    """(V, C) vertex attribute -> (N, C) perspective-correct per-pixel value."""
    return _weigh(geom.bary, attr[geom.corners])


def interpolate_with_grad(attr: torch.Tensor, geom: PixelGeom):
    """(value, d/dx, d/dy) of a (V, C) vertex attribute, each (N, C): the
    derivatives are the differences to the +1 px neighbours."""
    vals = attr[geom.corners]  # (N, 3, C)
    v = _weigh(geom.bary, vals)
    return v, _weigh(geom.bary_dx, vals) - v, _weigh(geom.bary_dy, vals) - v
