"""External asset formats (port of arkoserenderer_tpu/assets/external.py):
``CubeLUT`` parses Adobe .cube 3D colour-grading LUTs on the host, and
``apply_lut3d`` applies one on the device, as the Output pass's colour
grade; ``IESProfile`` parses IESNA LM-63 photometric profiles into the
spot lights' polar-angle LUT; ``HairFile`` reads Cem Yuksel's binary .hair
strands; ``DDSImage`` decodes DirectDraw Surface containers (uncompressed,
BC1, BC3, BC4, BC5 and BC7) into RGBA8 mips. All but ``apply_lut3d`` are
host NumPy.
"""

from __future__ import annotations

import dataclasses
import struct

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


# ---------------------------------------------------------------------------
# IES photometric profiles (IESNA LM-63)


@dataclasses.dataclass
class IESProfile:
    vertical_angles: np.ndarray    # (V,) degrees, 0 = down
    horizontal_angles: np.ndarray  # (H,) degrees
    candela: np.ndarray            # (H, V)

    @classmethod
    def parse(cls, text: str) -> "IESProfile":
        lines = text.splitlines()
        # Skip header until the TILT line.
        i = 0
        while i < len(lines) and not lines[i].upper().startswith("TILT"):
            i += 1
        assert i < len(lines), "malformed IES: no TILT"
        if "INCLUDE" in lines[i].upper():
            i += 4  # tilt data block (angles ignored for the LUT)
        i += 1
        numbers: list[float] = []
        for line in lines[i:]:
            numbers.extend(float(x) for x in line.replace(",", " ").split())
        n_lamps = int(numbers[0])
        lumens = numbers[1]
        multiplier = numbers[2]
        nv = int(numbers[3])
        nh = int(numbers[4])
        # numbers[5]=photometric type, 6=units, 7-9=dims, 10-12=ballast etc.
        idx = 13
        v_angles = np.array(numbers[idx : idx + nv], np.float32)
        idx += nv
        h_angles = np.array(numbers[idx : idx + nh], np.float32)
        idx += nh
        candela = (
            np.array(numbers[idx : idx + nv * nh], np.float32).reshape(nh, nv)
            * multiplier
        )
        return cls(vertical_angles=v_angles, horizontal_angles=h_angles, candela=candela)

    @classmethod
    def load(cls, path: str) -> "IESProfile":
        with open(path, errors="ignore") as f:
            return cls.parse(f.read())

    def to_lut(self, resolution: int = 256) -> np.ndarray:
        """(resolution,) normalized intensity vs polar angle [0, pi]
        (horizontal average) — the baked LUT the reference's IESConvertTool
        produces for spot lights."""
        avg = self.candela.mean(axis=0)  # (V,)
        angles = np.linspace(0.0, 180.0, resolution)
        lut = np.interp(angles, self.vertical_angles, avg, left=avg[0], right=avg[-1])
        peak = lut.max()
        return (lut / peak if peak > 0 else lut).astype(np.float32)


# ---------------------------------------------------------------------------
# Cem Yuksel .hair files


@dataclasses.dataclass
class HairFile:
    points: np.ndarray       # (P, 3)
    segments: np.ndarray     # (S,) points-per-strand - 1
    thickness: np.ndarray | None
    default_thickness: float

    @classmethod
    def load(cls, path: str) -> "HairFile":
        with open(path, "rb") as f:
            data = f.read()
        magic = data[:4]
        assert magic == b"HAIR", "not a .hair file"
        (n_strands, n_points, flags, d_segments) = struct.unpack_from("<IIII", data, 4)
        (d_thickness, d_transparency) = struct.unpack_from("<ff", data, 24)
        _d_color = struct.unpack_from("<fff", data, 32)
        off = 128
        segments = None
        if flags & 1:
            segments = np.frombuffer(data, np.uint16, n_strands, off).astype(np.int32)
            off += 2 * n_strands
        else:
            segments = np.full(n_strands, d_segments, np.int32)
        points = np.frombuffer(data, np.float32, n_points * 3, off).reshape(-1, 3).copy()
        off += 12 * n_points
        thickness = None
        if flags & 2:
            thickness = np.frombuffer(data, np.float32, n_points, off).copy()
            off += 4 * n_points
        return cls(points=points, segments=segments, thickness=thickness,
                   default_thickness=d_thickness)

    @property
    def num_strands(self) -> int:
        return len(self.segments)


# ---------------------------------------------------------------------------
# DDS images (DirectDraw Surface)
#
# Role-equivalent to arkcore/asset/external/DDSImage: decodes DDS containers
# into (H, W, 4) uint8 RGBA arrays for the texture pool. Supported payloads:
# uncompressed 32-bit masked RGB(A), DXT1/BC1, DXT5/BC3, ATI1/BC4, ATI2/BC5
# (BC4/BC5 through assets/meshopt.decompress_bc4) and BC7 (assets/bc7). Mip
# levels stored in the file are all decoded.

_DDS_MAGIC = 0x20534444  # "DDS "
_DDPF_FOURCC = 0x4
_DDPF_RGB = 0x40
_DXGI_TO_FOURCC = {71: b"DXT1", 77: b"DXT5", 80: b"ATI1", 83: b"ATI2",
                   98: b"BC7 ", 99: b"BC7S"}


def _decode_bc1_color(blocks: np.ndarray, h: int, w: int,
                      force_opaque: bool = False) -> np.ndarray:
    """(nblocks, 8) uint8 BC1 blocks -> (h, w, 4) uint8."""
    blk = blocks.reshape(-1, 8)
    c0 = blk[:, 0].astype(np.uint32) | (blk[:, 1].astype(np.uint32) << 8)
    c1 = blk[:, 2].astype(np.uint32) | (blk[:, 3].astype(np.uint32) << 8)

    def rgb565(c):
        r = ((c >> 11) & 31) * 255 // 31
        g = ((c >> 5) & 63) * 255 // 63
        b = (c & 31) * 255 // 31
        return np.stack([r, g, b], -1).astype(np.int32)

    p0, p1 = rgb565(c0), rgb565(c1)
    four_color = force_opaque | (c0 > c1)[:, None]
    p2 = np.where(four_color, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four_color, (p0 + 2 * p1) // 3, 0)
    pal = np.stack([p0, p1, p2, p3], axis=1).astype(np.uint8)      # (n, 4, 3)
    a3 = np.where(four_color[:, 0], 255, 0).astype(np.uint8)       # code-3 alpha
    bits = (blk[:, 4].astype(np.uint32) | (blk[:, 5].astype(np.uint32) << 8)
            | (blk[:, 6].astype(np.uint32) << 16) | (blk[:, 7].astype(np.uint32) << 24))
    out = np.zeros((len(blk), 16, 4), np.uint8)
    rows = np.arange(len(blk))
    for i in range(16):
        code = (bits >> (2 * i)) & 3
        out[:, i, :3] = pal[rows, code]
        out[:, i, 3] = np.where(code == 3, a3, 255)
    bh, bw = h // 4, w // 4
    return out.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(h, w, 4)


@dataclasses.dataclass
class DDSImage:
    width: int
    height: int
    mips: list          # list of (h, w, 4) uint8 RGBA, mip 0 first
    fourcc: str         # "RGBA" for uncompressed

    @classmethod
    def parse(cls, data: bytes) -> "DDSImage":
        from arkoserenderer_torch.assets import meshopt

        if struct.unpack_from("<I", data, 0)[0] != _DDS_MAGIC:
            raise ValueError("not a DDS file")
        (hsize, flags, height, width, _pitch, _depth, n_mips) = struct.unpack_from(
            "<7I", data, 4
        )
        if hsize != 124:
            raise ValueError("bad DDS header size")
        pf_flags, fourcc_raw = struct.unpack_from("<II", data, 80)
        bitcount, rmask, gmask, bmask, amask = struct.unpack_from("<5I", data, 88)
        off = 128
        fourcc = struct.pack("<I", fourcc_raw)
        if pf_flags & _DDPF_FOURCC and fourcc == b"DX10":
            dxgi = struct.unpack_from("<I", data, 128)[0]
            if dxgi not in _DXGI_TO_FOURCC:
                raise ValueError(f"unsupported DXGI format {dxgi}")
            fourcc = _DXGI_TO_FOURCC[dxgi]
            off = 148
        n_mips = max(n_mips, 1)
        mips = []
        h, w = height, width
        for _ in range(n_mips):
            if pf_flags & _DDPF_FOURCC:
                bh, bw = max(h + 3, 4) // 4 * 4, max(w + 3, 4) // 4 * 4
                nblk = (bh // 4) * (bw // 4)
                if fourcc == b"DXT1":
                    raw = np.frombuffer(data, np.uint8, nblk * 8, off)
                    img = _decode_bc1_color(raw, bh, bw)
                    off += nblk * 8
                elif fourcc == b"DXT5":
                    raw = np.frombuffer(data, np.uint8, nblk * 16, off).reshape(-1, 16)
                    img = _decode_bc1_color(raw[:, 8:], bh, bw, force_opaque=True)
                    img[..., 3] = meshopt.decompress_bc4(raw[:, :8], bh, bw)
                    off += nblk * 16
                elif fourcc in (b"ATI1", b"BC4U"):
                    raw = np.frombuffer(data, np.uint8, nblk * 8, off)
                    r = meshopt.decompress_bc4(raw, bh, bw)
                    img = np.dstack([r, r, r, np.full_like(r, 255)])
                    off += nblk * 8
                elif fourcc in (b"BC7 ", b"BC7S"):
                    from arkoserenderer_torch.assets import bc7

                    raw = np.frombuffer(data, np.uint8, nblk * 16, off)
                    img = bc7.decompress_bc7(raw, bh, bw)
                    off += nblk * 16
                elif fourcc in (b"ATI2", b"BC5U"):
                    raw = np.frombuffer(data, np.uint8, nblk * 16, off).reshape(-1, 16)
                    r = meshopt.decompress_bc4(raw[:, :8], bh, bw)
                    g = meshopt.decompress_bc4(raw[:, 8:], bh, bw)
                    img = np.dstack([r, g, np.full_like(r, 255), np.full_like(r, 255)])
                    off += nblk * 16
                else:
                    raise ValueError(f"unsupported DDS fourCC {fourcc!r}")
                img = img[:h, :w]
            elif pf_flags & _DDPF_RGB and bitcount == 32:
                raw = np.frombuffer(data, np.uint32, h * w, off).reshape(h, w)
                off += h * w * 4

                def chan(mask, default):
                    if mask == 0:
                        return np.full((h, w), default, np.uint8)
                    shift = int(mask & -mask).bit_length() - 1
                    return ((raw & mask) >> shift).astype(np.uint8)

                img = np.dstack([chan(rmask, 0), chan(gmask, 0),
                                 chan(bmask, 0), chan(amask, 255)])
            else:
                raise ValueError("unsupported DDS pixel format")
            mips.append(img)
            h, w = max(h // 2, 1), max(w // 2, 1)
        name = fourcc.decode("ascii", "replace") if pf_flags & _DDPF_FOURCC else "RGBA"
        return cls(width=width, height=height, mips=mips, fourcc=name)

    @classmethod
    def load(cls, path: str) -> "DDSImage":
        with open(path, "rb") as f:
            return cls.parse(f.read())
