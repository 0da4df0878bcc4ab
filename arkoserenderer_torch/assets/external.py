"""External asset formats (port of arkoserenderer_tpu/assets/external.py,
the .cube LUT): ``CubeLUT`` parses Adobe .cube 3D colour-grading LUTs on
the host, and ``apply_lut3d`` applies one on the device, as the Output
pass's colour grade.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class CubeLUT:
    size: int
    table: np.ndarray      # (S, S, S, 3) indexed [b][g][r]
    domain_min: np.ndarray
    domain_max: np.ndarray

    @classmethod
    def parse(cls, text: str) -> "CubeLUT":
        """A .cube file's text: LUT_3D_SIZE, DOMAIN_MIN/MAX and S^3 rows of
        r g b with red varying fastest; comments, TITLE and LUT_1D_SIZE
        lines are skipped. A malformed file raises ValueError."""
        size = 0
        dmin = np.zeros(3, np.float32)
        dmax = np.ones(3, np.float32)
        rows = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0].upper()
            if key == "LUT_3D_SIZE":
                size = int(parts[1])
            elif key == "DOMAIN_MIN":
                dmin = np.array(parts[1:4], np.float32)
            elif key == "DOMAIN_MAX":
                dmax = np.array(parts[1:4], np.float32)
            elif key in ("TITLE", "LUT_1D_SIZE"):
                continue
            else:
                try:
                    rows.append([float(p) for p in parts[:3]])
                except ValueError:
                    continue
        if size <= 0 or len(rows) != size ** 3:
            raise ValueError(f"malformed .cube: size {size}, {len(rows)} rows")
        table = np.array(rows, np.float32).reshape(size, size, size, 3)
        return cls(size=size, table=table, domain_min=dmin, domain_max=dmax)

    @classmethod
    def load(cls, path: str) -> "CubeLUT":
        with open(path) as f:
            return cls.parse(f.read())

    @classmethod
    def identity(cls, size: int = 16) -> "CubeLUT":
        g = np.linspace(0, 1, size, dtype=np.float32)
        b, gg, r = np.meshgrid(g, g, g, indexing="ij")
        table = np.stack([r, gg, b], axis=-1)
        return cls(size=size, table=table,
                   domain_min=np.zeros(3, np.float32), domain_max=np.ones(3, np.float32))


def apply_lut3d(lut_table: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Trilinear 3D LUT lookup of ``color`` (..., 3), clipped to [0, 1];
    ``lut_table`` (S, S, S, 3) indexed [b][g][r] (the .cube convention), on
    the colour's device."""
    s = lut_table.shape[0]
    c = torch.clamp(color, 0.0, 1.0) * (s - 1)
    c0 = torch.floor(c).to(torch.int64)
    c1 = torch.clamp(c0 + 1, max=s - 1)
    f = c - c0.to(c.dtype)
    flat = lut_table.reshape(-1, 3)

    def fetch(ri, gi, bi):
        return flat[(bi * s + gi) * s + ri]

    r0, g0, b0 = c0[..., 0], c0[..., 1], c0[..., 2]
    r1, g1, b1 = c1[..., 0], c1[..., 1], c1[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = fetch(r0, g0, b0) * (1 - fr) + fetch(r1, g0, b0) * fr
    c10 = fetch(r0, g1, b0) * (1 - fr) + fetch(r1, g1, b0) * fr
    c01 = fetch(r0, g0, b1) * (1 - fr) + fetch(r1, g0, b1) * fr
    c11 = fetch(r0, g1, b1) * (1 - fr) + fetch(r1, g1, b1) * fr
    c0_ = c00 * (1 - fg) + c10 * fg
    c1_ = c01 * (1 - fg) + c11 * fg
    return c0_ * (1 - fb) + c1_ * fb
