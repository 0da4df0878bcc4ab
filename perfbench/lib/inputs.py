"""The inputs both sides are handed: the whole scene as authored on the host
and the camera's settings, as plain arrays and numbers. The reference works
out everything else itself: pools, transforms, culling, rasters, shading,
acceleration structures and history. Nothing the program derives from these
(its built scene arrays, packed textures, BVH, matrices) is passed on.

What arrives, and refusing nothing:

  segments    positions, normals, uvs, tangents, indices, material; where
              skinned its skeleton, joints and weights; where morphed its
              position and normal deltas
  instances   segment, world, previous world (None: the world), LOD band,
              the animation clip that drives it (None: none)
  materials   every field: factors, the five texture ids as authored (0-3
              the defaults white, black, flat normal, grey), emissive, blend
              mode and alpha cutoff, double-sided, clearcoat, subsurface
  images      each texture by id: RGBA8, its sRGB flag, repeat or clamp
  sun         direction, colour, illuminance, shadow casting, angular
              radius (None where the scene has no sun)
  spots       position, direction, colour, intensity, inner and outer cone
              angles, shadow casting, source radius, IES table or None
  points      position, colour, intensity, shadow casting, source radius
  env         the equirectangular map, its brightness, the flat ambient
  camera      orientation, optics, exposure, near and far (None: infinite),
              focus, jitter
  skeletons, clips   the scene's animation data as arrays (not the morph
              weights, which the scene reads out only once it is built)

A reference refuses, in its ``Frame``, what it cannot render."""

from __future__ import annotations

import numpy as np


def arr(x, dtype=np.float32):
    return None if x is None else np.array(x, dtype)


def scene_inputs(scene, camera) -> dict:
    segments = []
    for s in scene.segments:
        idx = np.arange(len(s.positions)) if s.indices is None else np.asarray(s.indices)
        segments.append({"positions": arr(s.positions), "normals": arr(s.normals),
                         "uvs": arr(s.uvs), "tangents": arr(s.tangents),
                         "indices": idx.astype(np.int64).reshape(-1),
                         "material": int(s.material), "skeleton": int(s.skeleton),
                         "skin_joints": arr(s.skin_joints, np.int64),
                         "skin_weights": arr(s.skin_weights),
                         "morph_pos": arr(s.morph_pos), "morph_nrm": arr(s.morph_nrm)})
    clips = scene.instance_clips
    instances = [{"segment": int(sid), "world": arr(world), "prev_world": arr(prev),
                  "lod_band": (float(band[0]), float(band[1])),
                  "clip": None if i not in clips else int(clips[i])}
                 for i, (sid, world, prev, band) in enumerate(scene.instances)]
    images = [{"rgba": np.array(img, np.uint8), "srgb": bool(srgb), "repeat": int(wrap) == 0}
              for img, srgb, wrap in scene.texture_builder.images]
    materials = [{"base_color_factor": arr(m.base_color_factor),
                  "emissive_factor": arr(m.emissive_factor),
                  "metallic_factor": float(m.metallic_factor),
                  "roughness_factor": float(m.roughness_factor),
                  "base_color_tex": int(m.base_color_tex), "normal_tex": int(m.normal_tex),
                  "mr_tex": int(m.mr_tex), "emissive_tex": int(m.emissive_tex),
                  "occlusion_tex": int(m.occlusion_tex), "blend_mode": int(m.blend_mode),
                  "alpha_cutoff": float(m.alpha_cutoff), "double_sided": bool(m.double_sided),
                  "clearcoat": float(m.clearcoat),
                  "clearcoat_roughness": float(m.clearcoat_roughness),
                  "subsurface": float(m.subsurface)}
                 for m in scene.materials]
    sun = scene.sun
    if sun is not None:
        sun = {"direction": arr(sun.direction), "color": arr(sun.color),
               "illuminance_lux": float(sun.illuminance_lux),
               "cast_shadows": bool(sun.cast_shadows),
               "angular_radius_deg": float(sun.angular_radius_deg)}
    spots = [{"position": arr(s.position), "direction": arr(s.direction), "color": arr(s.color),
              "luminous_intensity_cd": float(s.luminous_intensity_cd),
              "inner_cone_angle": float(s.inner_cone_angle),
              "outer_cone_angle": float(s.outer_cone_angle),
              "cast_shadows": bool(s.cast_shadows), "source_radius": float(s.source_radius),
              "ies_lut": arr(s.ies_lut)}
             for s in scene.spots]
    points = [{"position": arr(p.position), "color": arr(p.color),
               "luminous_intensity_cd": float(p.luminous_intensity_cd),
               "cast_shadows": bool(p.cast_shadows), "source_radius": float(p.source_radius)}
              for p in scene.points]
    skeletons = [{"parents": arr(k.parents, np.int64), "inverse_bind": arr(k.inverse_bind),
                  "rest_translation": arr(k.rest_translation),
                  "rest_rotation": arr(k.rest_rotation), "rest_scale": arr(k.rest_scale)}
                 for k in scene.skeletons]
    clips = [{"name": c.name,
              "channels": [{"target_joint": int(ch.target_joint), "path": ch.path,
                            "times": arr(ch.times), "values": arr(ch.values),
                            "interpolation": int(ch.interpolation)} for ch in c.channels]}
             for c in scene.animations]
    return {
        "segments": segments, "instances": instances, "materials": materials,
        "images": images, "sun": sun, "spots": spots, "points": points,
        "skeletons": skeletons, "clips": clips,
        "env": {"map": np.array(scene.env_map, np.float32),
                "brightness": float(scene.env_brightness), "ambient_lx": float(scene.ambient_lx)},
        "camera": {"orientation": arr(camera.orientation),
                   "focal_length_mm": float(camera.focal_length_mm),
                   "sensor_w_mm": float(camera.sensor_size_mm[0]),
                   "sensor_h_mm": float(camera.sensor_size_mm[1]),
                   "f_number": float(camera.f_number),
                   "shutter_speed": float(camera.shutter_speed), "iso": float(camera.iso),
                   "exposure_compensation": float(camera.exposure_compensation),
                   "focus_depth": float(camera.focus_depth),
                   "near": float(camera.near),
                   "far": None if camera.far is None else float(camera.far),
                   "jitter": bool(camera.jitter_enabled),
                   "jitter_period": int(camera.jitter_period)},
    }
