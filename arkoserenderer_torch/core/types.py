"""Framework-wide constants and fixed capacities (port of
arkoserenderer_tpu/core/types.py).

Pools keep the reference's fixed capacities so both packages build
identical scene arrays from the same host scene.
"""

from __future__ import annotations

import dataclasses

# Sentinel for "no triangle" in the visibility buffer.
VIS_NONE = -1
# Clear value of a reverse-Z depth buffer (near = 1, far = 0).
DEPTH_FAR = 0.0


@dataclasses.dataclass(frozen=True)
class SceneLimits:
    """Fixed-capacity pool sizes for a scene."""

    max_vertices: int = 12 << 20
    max_indices: int = 48 << 20
    max_drawables: int = 65536
    max_materials: int = 10000
    max_textures: int = 4096
    max_spot_lights: int = 16
    max_point_lights: int = 16
    texture_pool_texels: int = 1 << 24

    @property
    def max_triangles(self) -> int:
        return self.max_indices // 3


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Tile rasterizer configuration.

    ``tile_h`` x ``tile_w`` pixels form one raster tile (one CUDA thread
    block); ``max_tris_per_tile`` caps each tile's binned list (overflow is
    dropped and counted); triangles spanning more than
    ``max_tiles_per_tri`` tiles go to the ``max_global_tris`` list that
    every tile walks.

    The CUDA kernel takes fewer tiles than the plain version: tile_w <= 128
    with 1, 2, 4, 8 or 16 rows a thread (8x16 and 8x128 are taken; 32x128,
    64x64 and 8x256 are not). ``ops.raster_cuda.check_tile`` states the
    rule, and ``rasterize_tiles`` raises ValueError on CUDA tensors for a
    tile outside it.
    """

    tile_h: int = 8
    tile_w: int = 128
    max_tris_per_tile: int = 512
    max_tiles_per_tri: int = 16
    max_global_tris: int = 256
