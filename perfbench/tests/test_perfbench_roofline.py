"""The frozen roofline arithmetic against bytes worked out by hand."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.roofline import bounds  # noqa: E402


def test_one_raster():
    # 1920 x 1080 pixels, a 4-byte id and a 4-byte depth each.
    assert bounds.raster_bytes(1920, 1080, False) == 16_588_800
    # the 8192^2 sun map, depth only.
    assert bounds.raster_bytes(8192, 8192, True) == 268_435_456


def test_one_trace():
    # 2,073,600 rays of 24 bytes read and 16 written, 1,742 triangles of 36.
    assert bounds.trace_bytes(2_073_600, 1_742) == 82_944_000 + 62_712


def test_a_frame_of_each_configuration():
    showcase = {"width": 1920, "height": 1080, "scene_triangles": 1742,
                "ddgi": {"rays_per_probe": 128, "probes_per_frame": 64},
                "traces_per_frame": {"a": "pixels", "b": "pixels", "c": "pixels",
                                     "d": "ddgi", "e": "ddgi"},
                "rasters_per_frame": [{"what": "camera", "depth_only": False}]}
    assert bounds.frame_trace_bytes(showcase) == 3 * 83_006_712 + 2 * (8_192 * 40 + 62_712)
    assert bounds.frame_raster_bytes(showcase) == 16_588_800
    stress = {"width": 1920, "height": 1080, "shadow_map_size": 8192,
              "rasters_per_frame": [{"what": "camera", "depth_only": False},
                                    {"what": "sun", "depth_only": True}]}
    assert bounds.frame_raster_bytes(stress) == 16_588_800 + 268_435_456
    assert bounds.frame_trace_bytes(stress) == 0
    assert abs(bounds.least_seconds(3.35e12) - 1.0) < 1e-12
