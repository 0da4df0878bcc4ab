"""The inputs both sides are handed: the scene as authored on the host (its
segments, instances, materials, texture images, sun and environment) and
the camera's settings, as plain arrays and numbers. The reference works out
everything else itself: pools, transforms, culling, rasters, shading and
history. Nothing the program derives from these (its built scene arrays,
packed textures, matrices) is passed on.

The reference covers the forward features these cells use; a scene that
uses another (local lights, normal, emissive or metal-roughness textures,
double-sided or clearcoat materials, a finite far plane) is refused here
rather than compared wrongly."""

from __future__ import annotations

import numpy as np

DEFAULT_TEXTURES = 4  # ids 0-3 are the pool's default white, black, flat normal, grey


def scene_inputs(scene, camera) -> dict:
    if scene.spots or scene.points:
        raise ValueError("the reference renders a sun alone")
    if camera.far is not None:
        raise ValueError("the reference's projection has an infinite far plane")
    segments = []
    for s in scene.segments:
        idx = np.arange(len(s.positions)) if s.indices is None else np.asarray(s.indices)
        segments.append({"positions": np.array(s.positions, np.float32),
                         "normals": np.array(s.normals, np.float32),
                         "uvs": np.array(s.uvs, np.float32),
                         "indices": idx.astype(np.int64).reshape(-1),
                         "material": int(s.material)})
    instances = []
    for sid, world, prev, band in scene.instances:
        if prev is not None:
            raise ValueError("the reference takes instance motion from the animation alone")
        instances.append({"segment": int(sid), "world": np.array(world, np.float32),
                          "lod_band": (float(band[0]), float(band[1]))})
    images = [{"rgba": np.array(img, np.uint8), "repeat": int(wrap) == 0}
              for img, _srgb, wrap in scene.texture_builder.images]
    materials = []
    for m in scene.materials:
        if (m.normal_tex != 2 or m.mr_tex != 0 or m.emissive_tex != 0 or m.occlusion_tex != 0
                or m.double_sided or m.clearcoat or np.any(np.asarray(m.emissive_factor))):
            raise ValueError("the reference's materials have a base colour texture alone")
        tex = int(m.base_color_tex)
        materials.append({
            "base_color_factor": np.array(m.base_color_factor, np.float32),
            "metallic_factor": float(m.metallic_factor),
            "roughness_factor": float(m.roughness_factor),
            "base_color_tex": tex if DEFAULT_TEXTURES <= tex < len(images) else None})
    sun = scene.sun
    return {
        "segments": segments, "instances": instances, "materials": materials,
        "images": images,
        "sun": {"direction": np.array(sun.direction, np.float32),
                "color": np.array(sun.color, np.float32),
                "illuminance_lux": float(sun.illuminance_lux)},
        "env": {"map": np.array(scene.env_map, np.float32),
                "brightness": float(scene.env_brightness), "ambient_lx": float(scene.ambient_lx)},
        "camera": {"orientation": np.array(camera.orientation, np.float32),
                   "focal_length_mm": float(camera.focal_length_mm),
                   "sensor_w_mm": float(camera.sensor_size_mm[0]),
                   "f_number": float(camera.f_number),
                   "shutter_speed": float(camera.shutter_speed), "iso": float(camera.iso),
                   "exposure_compensation": float(camera.exposure_compensation),
                   "near": float(camera.near), "jitter": bool(camera.jitter_enabled),
                   "jitter_period": int(camera.jitter_period)},
    }
