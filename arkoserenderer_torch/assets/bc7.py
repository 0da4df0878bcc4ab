"""BC7 block compression: FULL 8-mode encoder (+ optional RDO) and decoder
(port of arkoserenderer_tpu/assets/bc7.py, block for block).

Role-equivalent to the reference's TextureCompressor BC7 path
(arkcore/asset/TextureCompressor.cpp, which wraps the vendored bc7enc
library): high-quality RGBA block compression for color textures. The
ENCODER searches the full profile — all 8 modes, partitions, rotations,
index-swap, p-bits — picking the least-error candidate per block (mode 6
remains the workhorse for smooth color content), with an optional
rate-distortion pass that biases blocks toward byte-identical neighbors
for better LZ compressibility. The DECODER covers all 8 modes (partitions,
p-bits, rotations, dual index sets), so any externally-produced BC7 .dds
loads correctly; both are fuzz-verified block-for-block against an
independent decoder (Pillow's BCn codec) in tests.

The partition and anchor-index tables below are the BC7 format's fixed
spec constants (Khronos Data Format / D3D11 functional spec section on
BPTC), transcribed via an oracle-recovery harness and verified entry by
entry against the independent decoder.

Everything is host-side NumPy, vectorized over blocks (bake-time code).

Mode 6 bit layout (LSB-first across the 16-byte block):
  [0..6]   mode bits: six zeros then a one (first set bit at position 6)
  [7..62]  endpoints R0 R1 G0 G1 B0 B1 A0 A1, 7 bits each
  [63..64] p-bits P0 P1 (the endpoints' shared low bit)
  [65..127] 4-bit indices, texel 0's MSB omitted (anchor; always 0)
"""

from __future__ import annotations

import numpy as np

# The spec's interpolation weights: c = ((64-w)*e0 + w*e1 + 32) >> 6.
_WEIGHTS2 = np.array([0, 21, 43, 64], np.int64)
_WEIGHTS3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int64)
_WEIGHTS4 = np.array(
    [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], np.int64
)
_WEIGHTS = {2: _WEIGHTS2, 3: _WEIGHTS3, 4: _WEIGHTS4}

# Mode parameters: (subsets, partition bits, rotation bits, index-selection
# bit, color bits, alpha bits, per-endpoint p-bits, shared p-bits, index
# bits, secondary index bits).
_MODES = {
    0: (3, 4, 0, 0, 4, 0, 1, 0, 3, 0),
    1: (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
    2: (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
    3: (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
    4: (1, 0, 2, 1, 5, 6, 0, 0, 2, 3),
    5: (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
    6: (1, 0, 0, 0, 7, 7, 1, 0, 4, 0),
    7: (2, 6, 0, 0, 5, 5, 1, 0, 2, 0),
}

_PARTITION2 = np.array([
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1],
    [0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
    [0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1],
    [0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [0, 1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0],
    [0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0],
    [0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1],
    [0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0],
    [0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0],
    [0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 0],
    [0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
    [0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0],
    [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1],
    [0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1],
    [0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0],
    [0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0],
    [0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0],
    [0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0],
    [0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1],
    [0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1],
    [0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0],
    [0, 0, 0, 1, 0, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0],
    [0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0],
    [0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 0],
    [0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0],
    [0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 1, 1],
    [0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1],
    [0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0],
    [0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0],
    [0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0],
    [0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1],
    [0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0],
    [0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0],
    [0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1],
    [0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1],
    [0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1],
    [0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1],
    [0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0],
    [0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1],
], np.int64)

_PARTITION3 = np.array([
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 1, 2, 2, 2, 2],
    [0, 0, 0, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 2, 0, 0, 1, 2, 2, 1, 1, 2, 2, 1, 1],
    [0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2],
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 2, 2],
    [0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2],
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2],
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2],
    [0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2, 0, 1, 1, 2],
    [0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2, 0, 1, 2, 2],
    [0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2, 1, 2, 2, 2],
    [0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0, 2, 2, 2, 0],
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 2, 1, 1, 2, 2],
    [0, 1, 1, 1, 0, 0, 1, 1, 2, 0, 0, 1, 2, 2, 0, 0],
    [0, 0, 0, 0, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2],
    [0, 0, 2, 2, 0, 0, 2, 2, 0, 0, 2, 2, 1, 1, 1, 1],
    [0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 2, 2, 2],
    [0, 0, 0, 1, 0, 0, 0, 1, 2, 2, 2, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2],
    [0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 1, 0, 2, 2, 1, 0],
    [0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1, 0, 0, 0, 0],
    [0, 0, 1, 2, 0, 0, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2],
    [0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1, 0, 1, 1, 0],
    [0, 0, 0, 0, 0, 1, 1, 0, 1, 2, 2, 1, 1, 2, 2, 1],
    [0, 0, 2, 2, 1, 1, 0, 2, 1, 1, 0, 2, 0, 0, 2, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 2, 0, 0, 2, 2, 2, 2, 2],
    [0, 0, 1, 1, 0, 1, 2, 2, 0, 1, 2, 2, 0, 0, 1, 1],
    [0, 0, 0, 0, 2, 0, 0, 0, 2, 2, 1, 1, 2, 2, 2, 1],
    [0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 2, 2, 2],
    [0, 2, 2, 2, 0, 0, 2, 2, 0, 0, 1, 2, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 2, 0, 2, 2, 2],
    [0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2, 0],
    [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0],
    [0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0],
    [0, 1, 2, 0, 2, 0, 1, 2, 1, 2, 0, 1, 0, 1, 2, 0],
    [0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2, 2, 0, 0, 1, 1],
    [0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0, 1, 1],
    [0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1],
    [0, 0, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2, 1, 1, 2, 2],
    [0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 2, 2, 0, 0, 1, 1],
    [0, 2, 2, 0, 1, 2, 2, 1, 0, 2, 2, 0, 1, 2, 2, 1],
    [0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 0, 1, 0, 1],
    [0, 0, 0, 0, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1],
    [0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2],
    [0, 2, 2, 2, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1],
    [0, 0, 0, 2, 1, 1, 1, 2, 0, 0, 0, 2, 1, 1, 1, 2],
    [0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2, 2, 1, 1, 2],
    [0, 2, 2, 2, 0, 1, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2],
    [0, 0, 0, 2, 1, 1, 1, 2, 1, 1, 1, 2, 0, 0, 0, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2, 2, 1, 1, 2],
    [0, 1, 1, 0, 0, 1, 1, 0, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 0, 2, 2, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2],
    [0, 0, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2, 0, 0, 2, 2],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 1, 1, 2],
    [0, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1],
    [0, 2, 2, 2, 1, 2, 2, 2, 0, 2, 2, 2, 1, 2, 2, 2],
    [0, 1, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 1, 1, 1, 2, 0, 1, 1, 2, 2, 0, 1, 2, 2, 2, 0],
], np.int64)

_ANCHOR2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
], np.int64)

_ANCHOR3_A = np.array([
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3,
    3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15,
    3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
], np.int64)

_ANCHOR3_B = np.array([
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8,
    15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8,
    15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
], np.int64)



def _blocks_from_image(img: np.ndarray):
    h, w = img.shape[:2]
    assert h % 4 == 0 and w % 4 == 0, "BC7 needs 4x4-aligned dimensions"
    b = img.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return b.reshape(-1, 16, 4).astype(np.int64)  # (nblocks, texel, rgba)


def _image_from_blocks(texels: np.ndarray, h: int, w: int):
    b = texels.reshape(h // 4, w // 4, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return b.reshape(h, w, 4).astype(np.uint8)


def _pack_bits(fields):
    """fields: list of (value_array (n,), nbits) LSB-first -> (n, 16) uint8."""
    n = len(fields[0][0])
    out = np.zeros((n, 128), bool)
    pos = 0
    for val, bits in fields:
        for i in range(bits):
            out[:, pos] = (val >> i) & 1
            pos += 1
    assert pos == 128
    return np.packbits(out, axis=1, bitorder="little")


def _unpack_bits(blocks: np.ndarray):
    return np.unpackbits(blocks.reshape(-1, 16), axis=1, bitorder="little")


def compress_bc7_mode6(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (H/4 * W/4, 16) uint8 BC7 mode-6 blocks.

    Endpoints are the block's farthest color pair; indices project texels
    onto the endpoint segment.
    """
    px = _blocks_from_image(img)                       # (n, 16, 4)
    # Endpoint selection: the farthest-pair heuristic (exact for two-color
    # blocks, near-principal-axis otherwise): the texel farthest from the
    # block mean, then the texel farthest from THAT one.
    n = len(px)
    rows = np.arange(n)
    mean = px.mean(axis=1, keepdims=True)
    i0 = np.argmax(((px - mean) ** 2).sum(-1), axis=1)
    lo = px[rows, i0]                                  # (n, 4)
    i1 = np.argmax(((px - lo[:, None, :]) ** 2).sum(-1), axis=1)
    hi = px[rows, i1]

    # Project texels onto the lo->hi segment for index selection.
    axis = (hi - lo).astype(np.float64)                # (n, 4)
    denom = (axis * axis).sum(-1)
    denom = np.where(denom > 0, denom, 1.0)
    t = ((px - lo[:, None, :]) * axis[:, None, :]).sum(-1) / denom[:, None]
    idx = np.clip(np.rint(t * 15.0), 0, 15).astype(np.int64)   # (n, 16)

    # Anchor constraint: texel 0's index MSB must be 0 — swap endpoints
    # (and flip indices) where it is not.
    swap = idx[:, 0] >= 8
    lo2 = np.where(swap[:, None], hi, lo)
    hi2 = np.where(swap[:, None], lo, hi)
    idx = np.where(swap[:, None], 15 - idx, idx)

    # Quantize endpoints to 7 bits + a shared-per-endpoint p-bit (low bit).
    def quant(e):
        p = (e >> 0) & 1                 # take the low bit majority-free
        p = (p.sum(-1) >= 2).astype(np.int64)  # one p-bit across channels
        e7 = np.clip((e - p[:, None]) >> 1, 0, 127)
        return e7, p

    e0, p0 = quant(lo2)
    e1, p1 = quant(hi2)

    # Index field: texel 0 uses 3 bits (anchor), the rest 4 — pack as one
    # 63-bit little-endian integer per block.
    idx_field = np.zeros(len(px), dtype=object)
    shift = 0
    for i in range(16):
        bits = 3 if i == 0 else 4
        idx_field = idx_field + (idx[:, i].astype(object) << shift)
        shift += bits

    fields = [
        (np.full(len(px), 1 << 6, np.int64), 7),       # mode 6 marker
        (e0[:, 0], 7), (e1[:, 0], 7),
        (e0[:, 1], 7), (e1[:, 1], 7),
        (e0[:, 2], 7), (e1[:, 2], 7),
        (e0[:, 3], 7), (e1[:, 3], 7),
        (p0, 1), (p1, 1),
        (idx_field, 63),
    ]
    # _pack_bits needs int shifts; expand the object-int index field here.
    out = np.zeros((n, 128), bool)
    pos = 0
    for val, bits in fields:
        v = val
        for i in range(bits):
            if v.dtype == object:
                out[:, pos] = np.array([(int(x) >> i) & 1 for x in v], bool)
            else:
                out[:, pos] = (v >> i) & 1
            pos += 1
    assert pos == 128
    return np.packbits(out, axis=1, bitorder="little")


def _dequant(e: np.ndarray, bits: int) -> np.ndarray:
    """Endpoint (already p-bit-extended) at ``bits`` precision -> 8 bits:
    left-align then replicate the top bits (the spec's unquantization)."""
    v = e << (8 - bits)
    return v | (v >> bits)


def _decode_mode(bits: np.ndarray, mode: int) -> np.ndarray:
    """Decode all blocks of one mode. ``bits``: (n, 128) LSB-first bools.
    Returns (n, 16, 4) uint8 texels."""
    n = bits.shape[0]
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _MODES[mode]
    pos = mode + 1                       # mode marker: m zeros then a 1

    def field(nb):
        nonlocal pos
        v = np.zeros(n, np.int64)
        for i in range(nb):
            v |= bits[:, pos + i].astype(np.int64) << i
        pos += nb
        return v

    part = field(pb) if pb else np.zeros(n, np.int64)
    rot = field(rb) if rb else np.zeros(n, np.int64)
    sel = field(isb) if isb else np.zeros(n, np.int64)

    ne = 2 * ns                          # endpoints
    color = np.zeros((n, ne, 3), np.int64)
    for ch in range(3):
        for e in range(ne):
            color[:, e, ch] = field(cb)
    alpha = np.zeros((n, ne), np.int64)
    if ab:
        for e in range(ne):
            alpha[:, e] = field(ab)

    # P-bits extend every channel (including alpha when present).
    cbits, abits = cb, ab
    if epb:
        for e in range(ne):
            pbit = field(1)
            color[:, e] = (color[:, e] << 1) | pbit[:, None]
            if ab:
                alpha[:, e] = (alpha[:, e] << 1) | pbit
        cbits += 1
        abits += 1 if ab else 0
    elif spb:
        for sset in range(ns):
            pbit = field(1)
            for e in (2 * sset, 2 * sset + 1):
                color[:, e] = (color[:, e] << 1) | pbit[:, None]
        cbits += 1

    color8 = _dequant(color, cbits)                       # (n, ne, 3)
    alpha8 = _dequant(alpha, abits) if ab else np.full((n, ne), 255, np.int64)

    # Per-texel subset + anchor layout.
    if ns == 1:
        subset = np.zeros((n, 16), np.int64)
        anchors = [np.zeros(n, np.int64)]
    elif ns == 2:
        subset = _PARTITION2[part]                        # (n, 16)
        anchors = [np.zeros(n, np.int64), _ANCHOR2[part]]
    else:
        subset = _PARTITION3[part]
        anchors = [np.zeros(n, np.int64), _ANCHOR3_A[part], _ANCHOR3_B[part]]

    def read_indices(nbits):
        """Per-texel indices with anchor texels one bit short."""
        nonlocal pos
        idx = np.zeros((n, 16), np.int64)
        is_anchor = np.zeros((n, 16), bool)
        for k, a in enumerate(anchors):
            is_anchor[np.arange(n), a] = True
        # Bit widths vary per block (anchors differ by partition), so walk
        # texels accumulating a per-block cursor.
        cursor = np.full(n, pos, np.int64)
        cols = np.arange(n)
        for t in range(16):
            width = np.where(is_anchor[:, t], nbits - 1, nbits)
            v = np.zeros(n, np.int64)
            for i in range(nbits):           # upper bits read as 0 via mask
                take = i < width
                bit = bits[cols, np.minimum(cursor + i, 127)].astype(np.int64)
                v |= np.where(take, bit, 0) << i
            idx[:, t] = v
            cursor += width
        pos_delta = 16 * nbits - len(anchors)
        pos += pos_delta
        return idx

    idx1 = read_indices(ib)
    idx2 = read_indices(ib2) if ib2 else None

    # Select endpoints by subset, interpolate.
    e0c = np.take_along_axis(
        color8, (2 * subset)[:, :, None].repeat(3, 2), axis=1)     # (n,16,3)
    e1c = np.take_along_axis(
        color8, (2 * subset + 1)[:, :, None].repeat(3, 2), axis=1)
    e0a = np.take_along_axis(alpha8, 2 * subset, axis=1)           # (n,16)
    e1a = np.take_along_axis(alpha8, 2 * subset + 1, axis=1)

    # Index-selection bit (mode 4): sel=1 swaps which index set drives
    # color vs alpha.
    widx_c = _WEIGHTS[ib][idx1]
    if ib2:
        widx_a = _WEIGHTS[ib2][idx2]
        if isb:
            w_color = np.where(sel[:, None] == 1, widx_a, widx_c)
            w_alpha = np.where(sel[:, None] == 1, widx_c, widx_a)
        else:
            w_color, w_alpha = widx_c, widx_a
    else:
        w_color = w_alpha = widx_c

    rgb = ((64 - w_color[:, :, None]) * e0c + w_color[:, :, None] * e1c + 32) >> 6
    a = ((64 - w_alpha) * e0a + w_alpha * e1a + 32) >> 6
    texel = np.concatenate([rgb, a[:, :, None]], axis=-1)          # (n,16,4)

    # Rotation: swap alpha with one color channel (modes 4/5).
    if rb:
        for r, ch in ((1, 0), (2, 1), (3, 2)):
            m = rot == r
            if m.any():
                tmp = texel[m][:, :, ch].copy()
                sub = texel[m]
                sub[:, :, ch] = sub[:, :, 3]
                sub[:, :, 3] = tmp
                texel[m] = sub
    return np.clip(texel, 0, 255)


def decompress_bc7(blocks: np.ndarray, height: int, width: int) -> np.ndarray:
    """(nblocks, 16) or flat uint8 BC7 blocks -> (H, W, 4) uint8.

    Full 8-mode decoder (partitions / p-bits / rotations / dual index
    sets); fuzz-verified against an independent BCn decoder in
    tests/test_bc7.py. All-zero blocks (invalid: no mode bit) decode to
    transparent black, matching hardware behavior.
    """
    bits = _unpack_bits(np.ascontiguousarray(blocks, np.uint8)) > 0  # (n,128)
    n = bits.shape[0]
    texels = np.zeros((n, 16, 4), np.int64)
    mode_of = np.full(n, -1, np.int64)
    for m in range(8):
        is_m = (~bits[:, :m]).all(axis=1) & bits[:, m] if m else bits[:, 0]
        is_m = is_m & (mode_of < 0)
        mode_of[is_m] = m
        if is_m.any():
            texels[is_m] = _decode_mode(bits[is_m], m)
    return _image_from_blocks(np.clip(texels, 0, 255), height, width)


# -- Full-profile encoder (round-3: modes 0-7, bc7enc-style mode search) ------
#
# The reference's TextureCompressor wraps bc7enc_rdo's full-profile encoder
# (arkcore/asset/TextureCompressor.cpp:57-79). This is a from-scratch
# vectorized-numpy equivalent: per block, fit a small set of candidate modes
# (partitioned 2/3-subset opaque modes, rotation/dual-index alpha modes, and
# the mode-6 workhorse), then keep the lowest-RMSE encoding. Verified by
# round-tripping through the independent full-mode decoder above.

_ANCHOR_TABLES = None


def _anchors_for(ns: int, part: np.ndarray) -> list:
    n = len(part)
    if ns == 1:
        return [np.zeros(n, np.int64)]
    if ns == 2:
        return [np.zeros(n, np.int64), _ANCHOR2[part]]
    return [np.zeros(n, np.int64), _ANCHOR3_A[part], _ANCHOR3_B[part]]


def _subset_map(ns: int, part: np.ndarray) -> np.ndarray:
    if ns == 1:
        return np.zeros((len(part), 16), np.int64)
    table = _PARTITION2 if ns == 2 else _PARTITION3
    return table[part]


def _fit_endpoints(px: np.ndarray, subset: np.ndarray, ns: int):
    """Farthest-pair endpoints per subset. px (n,16,C) float64,
    subset (n,16) -> lo, hi (n, ns, C)."""
    n, _, c = px.shape
    rows = np.arange(n)
    lo = np.zeros((n, ns, c))
    hi = np.zeros((n, ns, c))
    for s in range(ns):
        m = (subset == s)
        cnt = np.maximum(m.sum(1, keepdims=True), 1)
        mean = (px * m[:, :, None]).sum(1) / cnt
        d2 = (((px - mean[:, None]) ** 2).sum(-1)) * m
        i0 = d2.argmax(1)
        p0 = px[rows, i0]
        d2b = (((px - p0[:, None]) ** 2).sum(-1)) * m
        i1 = d2b.argmax(1)
        lo[:, s] = p0
        hi[:, s] = px[rows, i1]
    return lo, hi


def _indices_of(px, e0, e1, levels):
    """Least-squares index along the endpoint segment. px/e0/e1 (n,16,C)."""
    axis = e1 - e0
    den = (axis * axis).sum(-1)
    den = np.where(den > 0, den, 1.0)
    t = ((px - e0) * axis).sum(-1) / den
    return np.clip(np.rint(t * (levels - 1)), 0, levels - 1).astype(np.int64)


def _cheap_partition_error(px, ns, part_ids):
    """Float farthest-pair projection error for every candidate partition:
    (n, len(part_ids)). No quantization — ranks partitions like bc7enc's
    estimator pass."""
    n = px.shape[0]
    errs = np.empty((n, len(part_ids)))
    for j, p in enumerate(part_ids):
        part = np.full(n, p, np.int64)
        subset = _subset_map(ns, part)
        lo, hi = _fit_endpoints(px, subset, ns)
        e0 = np.take_along_axis(lo, subset[:, :, None], axis=1)
        e1 = np.take_along_axis(hi, subset[:, :, None], axis=1)
        idx = _indices_of(px, e0, e1, 4)          # 2-bit proxy resolution
        w = idx / 3.0
        recon = e0 + w[:, :, None] * (e1 - e0)
        errs[:, j] = ((recon - px) ** 2).sum((1, 2))
    return errs


def _quant_endpoints(ep: np.ndarray, bits: int, pbit: np.ndarray | None):
    """Quantize 0..255 float endpoints to ``bits`` (+ optional p-bit low
    bit). Returns (stored, effective) ints; effective has bits(+1) width."""
    if pbit is None:
        maxv = (1 << bits) - 1
        q = np.clip(np.rint(ep / 255.0 * maxv), 0, maxv).astype(np.int64)
        return q, q
    maxv2 = (1 << (bits + 1)) - 1
    q2 = np.clip(np.rint(ep / 255.0 * maxv2), 0, maxv2).astype(np.int64)
    stored = np.clip((q2 - pbit) >> 1, 0, (1 << bits) - 1)
    return stored, (stored << 1) | pbit


def _encode_candidate(px, mode, part, rot, sel):
    """Encode ALL blocks under one fixed (mode, partition, rotation, sel).
    px: (n,16,4) float64 in 0..255 (already alpha-rotated for modes 4/5 —
    ``rot`` only affects the emitted header bits here).
    Returns (err (n,), pack dict)."""
    n = px.shape[0]
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _MODES[mode]
    rows = np.arange(n)
    subset = _subset_map(ns, part)
    anchors = _anchors_for(ns, part)
    has_alpha = ab > 0

    color_px = px[:, :, :3]
    lo, hi = _fit_endpoints(px if has_alpha and not ib2 else color_px,
                            subset, ns)
    # Dual-index modes (4/5) fit color and alpha separately.
    if ib2:
        lo_a = px[:, :, 3].min(1)     # ns == 1 for modes 4/5
        hi_a = px[:, :, 3].max(1)
        alpha_ep = np.stack([lo_a, hi_a], -1)[:, None, :]    # (n,1,2)
    elif has_alpha:
        alpha_ep = np.stack([lo[:, :, 3], hi[:, :, 3]], -1)  # (n,ns,2)
        lo, hi = lo[:, :, :3], hi[:, :, :3]
    else:
        alpha_ep = None

    # Quantize endpoints (+ p-bit search where the mode has them).
    def quant_all(pvals_lo, pvals_hi):
        slo, elo = _quant_endpoints(lo, cb, pvals_lo[:, :, None]
                                    if pvals_lo is not None else None)
        shi, ehi = _quant_endpoints(hi, cb, pvals_hi[:, :, None]
                                    if pvals_hi is not None else None)
        if alpha_ep is not None:
            pl = pvals_lo if (pvals_lo is not None and epb) else None
            ph = pvals_hi if (pvals_hi is not None and epb) else None
            sa0, ea0 = _quant_endpoints(alpha_ep[:, :, 0], ab, pl)
            sa1, ea1 = _quant_endpoints(alpha_ep[:, :, 1], ab, ph)
        else:
            sa0 = ea0 = sa1 = ea1 = None
        return slo, elo, shi, ehi, sa0, ea0, sa1, ea1

    cbits = cb + (1 if (epb or spb) else 0)
    abits = ab + (1 if (epb and has_alpha) else 0)

    def dequant_set(elo, ehi, ea0, ea1):
        d0 = _dequant(elo, cbits)
        d1 = _dequant(ehi, cbits)
        da0 = _dequant(ea0, abits) if ea0 is not None else None
        da1 = _dequant(ea1, abits) if ea1 is not None else None
        return d0, d1, da0, da1

    if epb or spb:
        # Try p=0 / p=1 per endpoint (epb) or per subset pair (spb); pick by
        # endpoint reconstruction error alone (cheap and near-optimal).
        best = None
        for p_lo in (0, 1):
            for p_hi in (0, 1):
                pl = np.full((n, ns), p_lo, np.int64)
                ph = np.full((n, ns), p_hi, np.int64)
                if spb:
                    ph = pl                     # shared across the pair
                    if p_hi != p_lo:
                        continue
                slo, elo, shi, ehi, sa0, ea0, sa1, ea1 = quant_all(pl, ph)
                d0, d1, da0, da1 = dequant_set(elo, ehi, ea0, ea1)
                e = ((d0 - lo) ** 2).sum(-1) + ((d1 - hi) ** 2).sum(-1)
                if da0 is not None:
                    e = e + (da0 - alpha_ep[:, :, 0]) ** 2 \
                          + (da1 - alpha_ep[:, :, 1]) ** 2
                cand = dict(slo=slo, shi=shi, sa0=sa0, sa1=sa1, pl=pl, ph=ph,
                            d0=d0, d1=d1, da0=da0, da1=da1, err=e)
                if best is None:
                    best = cand
                else:
                    take = (cand["err"] < best["err"])    # (n, ns)
                    for k in ("slo", "shi", "pl", "ph"):
                        best[k] = np.where(take[:, :, None]
                                           if best[k].ndim == 3 else take,
                                           cand[k], best[k])
                    for k in ("d0", "d1"):
                        best[k] = np.where(take[:, :, None], cand[k], best[k])
                    for k in ("sa0", "sa1", "da0", "da1"):
                        if best[k] is not None:
                            best[k] = np.where(take, cand[k], best[k])
                    best["err"] = np.where(take, cand["err"], best["err"])
        slo, shi = best["slo"], best["shi"]
        sa0, sa1 = best["sa0"], best["sa1"]
        p_lo, p_hi = best["pl"], best["ph"]
        d0, d1, da0, da1 = best["d0"], best["d1"], best["da0"], best["da1"]
    else:
        slo, elo, shi, ehi, sa0, ea0, sa1, ea1 = quant_all(None, None)
        d0, d1, da0, da1 = dequant_set(elo, ehi, ea0, ea1)
        p_lo = p_hi = None

    # Per-texel dequantized endpoints -> indices.
    e0t = np.take_along_axis(d0, subset[:, :, None], axis=1)   # (n,16,3)
    e1t = np.take_along_axis(d1, subset[:, :, None], axis=1)
    if has_alpha and not ib2:
        # Single index set drives RGBA: project in 4D.
        a0t = np.take_along_axis(da0, subset, axis=1)[:, :, None]
        a1t = np.take_along_axis(da1, subset, axis=1)[:, :, None]
        idx = _indices_of(px, np.concatenate([e0t, a0t], -1),
                          np.concatenate([e1t, a1t], -1), 1 << ib)
    elif not ib2:
        idx = _indices_of(color_px, e0t, e1t, 1 << ib)
    if ib2:
        a0t = np.broadcast_to(da0, (n, 16))
        a1t = np.broadcast_to(da1, (n, 16))
        if sel:   # 3-bit set drives color, 2-bit set drives alpha
            idx_c = _indices_of(color_px, e0t, e1t, 1 << ib2)
            idx_a = _indices_of(px[:, :, 3:4], a0t[:, :, None],
                                a1t[:, :, None], 1 << ib)
            idx, idx2 = idx_a, idx_c
        else:
            idx = _indices_of(color_px, e0t, e1t, 1 << ib)
            idx2 = _indices_of(px[:, :, 3:4], a0t[:, :, None],
                               a1t[:, :, None], 1 << ib2)
    else:
        idx2 = None

    # Anchor constraint: each subset's anchor index MSB must be 0; swap the
    # subset's endpoints (and flip its texel indices) where violated.
    half = 1 << (ib - 1)
    _IB2_SWAPPED = None
    for s, a in enumerate(anchors):
        viol = idx[rows, a] >= half                       # (n,)
        if s == 0:
            _IB2_SWAPPED = viol
        if not viol.any():
            continue
        vm = viol[:, None] & (subset == s)                # texels to flip
        idx = np.where(vm, (1 << ib) - 1 - idx, idx)
        for pair in ((slo, shi), (sa0, sa1) if sa0 is not None else None,
                     (p_lo, p_hi) if p_lo is not None else None,
                     (d0, d1), (da0, da1) if da0 is not None else None):
            if pair is None:
                continue
            x, y = pair
            if x.ndim == 3:
                tmp = x[viol, s].copy()
                x[viol, s] = y[viol, s]
                y[viol, s] = tmp
            else:
                tmp = x[viol, s].copy() if x.ndim == 2 else x[viol].copy()
                if x.ndim == 2:
                    x[viol, s] = y[viol, s]
                    y[viol, s] = tmp
                else:
                    x[viol] = y[viol]
                    y[viol] = tmp
    if ib2:
        # The swap above (driven by idx1's anchor) also swapped the alpha
        # endpoints, so flip the second index set for those blocks too, then
        # clamp its anchor MSB (standard encoder compromise — a re-swap
        # would re-violate idx1).
        swapped = _IB2_SWAPPED
        if swapped is not None and swapped.any():
            idx2 = np.where(swapped[:, None], (1 << ib2) - 1 - idx2, idx2)
        half2 = 1 << (ib2 - 1)
        a0 = anchors[0]
        idx2[rows, a0] = np.minimum(idx2[rows, a0], half2 - 1)

    # Reconstruct + error (in the rotated space == original space: the
    # rotation is a channel permutation).
    e0t = np.take_along_axis(d0, subset[:, :, None], axis=1)
    e1t = np.take_along_axis(d1, subset[:, :, None], axis=1)
    w_c = _WEIGHTS[ib][idx]
    if ib2:
        w_2 = _WEIGHTS[ib2][idx2]
        w_color, w_alpha = (w_2, w_c) if sel else (w_c, w_2)
        a0t = np.broadcast_to(da0, (n, 16))
        a1t = np.broadcast_to(da1, (n, 16))
    elif has_alpha:
        w_color = w_alpha = w_c
        a0t = np.take_along_axis(da0, subset, axis=1)
        a1t = np.take_along_axis(da1, subset, axis=1)
    else:
        w_color = w_alpha = w_c
        a0t = a1t = np.full((n, 16), 255, np.int64)
    rgb = ((64 - w_color[:, :, None]) * e0t + w_color[:, :, None] * e1t + 32) >> 6
    a = ((64 - w_alpha) * a0t + w_alpha * a1t + 32) >> 6
    recon = np.concatenate([rgb, a[:, :, None]], -1).astype(np.float64)
    err = ((recon - px) ** 2).sum((1, 2))

    return err, dict(mode=mode, part=part, rot=rot, sel=sel, slo=slo,
                     shi=shi, sa0=sa0, sa1=sa1, p_lo=p_lo, p_hi=p_hi,
                     idx=idx, idx2=idx2, anchors=anchors)


def _pack_candidate(c) -> np.ndarray:
    """Pack one candidate dict (all blocks) to (n,128) LSB-first bools,
    mirroring _decode_mode's field order exactly."""
    mode = c["mode"]
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _MODES[mode]
    n = len(c["part"])
    out = np.zeros((n, 128), bool)
    pos = mode + 1
    out[:, mode] = True                                  # marker bit

    def put(v, nb):
        nonlocal pos
        v = np.asarray(v, np.int64)
        for i in range(nb):
            out[:, pos + i] = (v >> i) & 1
        pos += nb

    if pb:
        put(c["part"], pb)
    if rb:
        put(np.full(n, c["rot"], np.int64), rb)
    if isb:
        put(np.full(n, c["sel"], np.int64), isb)
    ne = 2 * ns
    for ch in range(3):
        for s in range(ns):
            put(c["slo"][:, s, ch], cb)
            put(c["shi"][:, s, ch], cb)
    if ab:
        for s in range(ns):
            put(c["sa0"][:, s], ab)
            put(c["sa1"][:, s], ab)
    if epb:
        for s in range(ns):
            put(c["p_lo"][:, s], 1)
            put(c["p_hi"][:, s], 1)
    elif spb:
        for s in range(ns):
            put(c["p_lo"][:, s], 1)

    def write_indices(idx, nbits, anchors):
        nonlocal pos
        rows = np.arange(n)
        is_anchor = np.zeros((n, 16), bool)
        for a in anchors:
            is_anchor[rows, a] = True
        cursor = np.full(n, pos, np.int64)
        for t in range(16):
            width = np.where(is_anchor[:, t], nbits - 1, nbits)
            for i in range(nbits):
                take = i < width
                cols = np.minimum(cursor + i, 127)
                vals = ((idx[:, t] >> i) & 1).astype(bool) & take
                out[rows[vals], cols[vals]] = True
            cursor += width
        pos += 16 * nbits - len(anchors)

    write_indices(c["idx"], ib, c["anchors"])
    if ib2:
        write_indices(c["idx2"], ib2, c["anchors"])
    assert pos <= 128
    return out


def compress_bc7(img: np.ndarray, quality: str = "balanced",
                 rdo_lambda: float = 0.0) -> np.ndarray:
    """(H, W, 4) uint8 -> (H/4 * W/4, 16) uint8 BC7 blocks, full profile.

    Per block: encode under every candidate (mode, partition, rotation)
    combination for the quality tier, keep the lowest-error bits. Partition
    search uses a float estimator pass over all partitions, then a full
    quantized encode at each block's best partition (bc7enc's strategy).

    quality: "fast"     mode 6 only (== compress_bc7_mode6)
             "balanced" opaque: 6 + 1; alpha: 6 + 5 + 4(rot 0)
             "thorough" opaque: 6 + 1 + 3 + 2 + 0; alpha: + 7, all rotations
    rdo_lambda > 0 runs the rate-distortion repeat pass (rdo_bc7) on the
    result — smaller LZ-compressed size for bounded PSNR loss.
    """
    px_u8 = _blocks_from_image(img)
    if quality == "fast":
        blocks = compress_bc7_mode6(img)
        return rdo_bc7(img, blocks, rdo_lambda) if rdo_lambda > 0 else blocks
    px = px_u8.astype(np.float64)
    n = len(px)
    opaque = bool((px_u8[:, :, 3] == 255).all())

    # Start from the mode-6 encoding (always a candidate).
    best_bits = _unpack_bits(compress_bc7_mode6(img))
    texels6 = _decode_mode(best_bits, 6)
    best_err = ((texels6.astype(np.float64) - px) ** 2).sum((1, 2))

    def best_partition(ns, pb):
        ids = list(range(min(1 << pb, 64)))
        errs = _cheap_partition_error(px, ns, ids)
        return np.asarray(ids, np.int64)[errs.argmin(1)]

    candidates = []
    if opaque:
        modes = [1] if quality == "balanced" else [1, 3, 2, 0]
        for m in modes:
            ns, pb = _MODES[m][0], _MODES[m][1]
            candidates.append((m, best_partition(ns, pb), 0, 0))
    else:
        rots = [0] if quality == "balanced" else [0, 1, 2, 3]
        for m in ([5, 4] if quality == "balanced" else [5, 4]):
            for r in rots:
                sels = [0, 1] if m == 4 else [0]
                for s in sels:
                    candidates.append((m, np.zeros(n, np.int64), r, s))
        if quality == "thorough":
            candidates.append((7, best_partition(2, 6), 0, 0))

    for mode, part, rot, sel in candidates:
        if rot:
            ch = rot - 1
            pxr = px.copy()
            pxr[:, :, ch], pxr[:, :, 3] = px[:, :, 3], px[:, :, ch]
        else:
            pxr = px
        err, cand = _encode_candidate(pxr, mode, part, rot, sel)
        take = err < best_err
        if take.any():
            bits = _pack_candidate(cand)
            best_bits[take] = bits[take]
            best_err = np.where(take, err, best_err)

    blocks = np.packbits(best_bits, axis=1, bitorder="little")
    return rdo_bc7(img, blocks, rdo_lambda) if rdo_lambda > 0 else blocks


def _decode_blocks(blocks: np.ndarray) -> np.ndarray:
    """(n, 16) uint8 BC7 blocks (any mode mix) -> (n, 16, 4) texels."""
    bits = _unpack_bits(blocks)
    mode = np.argmax(bits, axis=1)
    out = np.zeros((len(blocks), 16, 4), np.uint8)
    for m in range(8):
        sel = mode == m
        if sel.any():
            out[sel] = _decode_mode(bits[sel], m)
    return out


def rdo_bc7(img: np.ndarray, blocks: np.ndarray, lambda_: float = 1.0,
            window: int = 16) -> np.ndarray:
    """Rate-distortion pass over encoded blocks (bc7enc_rdo's core idea,
    arkcore/asset/TextureCompressor.cpp:57-79 wraps that library): replace a
    block's 16 bytes with a PREVIOUS block's bytes when the MSE increase is
    small — byte-identical repeats are what LZ/deflate (and GPU-upload
    supercompression schemes) squeeze. ``lambda_`` trades PSNR for
    compressed size: accepted when
        (new_mse - old_mse) <= lambda_ * 96.0   (per-block, 8-bit scale).
    """
    if lambda_ <= 0.0 or len(blocks) < 2:
        return blocks
    px = _blocks_from_image(img).astype(np.float64)
    out = blocks.copy()
    base_err = ((_decode_blocks(out).astype(np.float64) - px) ** 2).sum((1, 2))
    budget = lambda_ * 96.0
    n = len(out)
    best_err = np.full(n, np.inf)
    best_src = np.full(n, -1, np.int64)
    for s in range(1, min(window, n - 1) + 1):
        cand = out[:-s]
        # Skip re-decode when candidate bytes equal the block's own bytes.
        err = ((_decode_blocks(cand).astype(np.float64) - px[s:]) ** 2).sum((1, 2))
        ok = err - base_err[s:] <= budget
        better = ok & (err < best_err[s:])
        best_err[s:][better] = err[better]
        best_src[s:][better] = (np.arange(n - s))[better]
    take = best_src >= 0
    out[take] = out[best_src[take]]
    return out
