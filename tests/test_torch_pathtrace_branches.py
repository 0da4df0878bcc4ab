"""Every branch of the port's ``trace_path`` against the JAX package's.

The branches run in one scene, the truth harness's flat scene (its
clearcoat sphere takes the Kelemen lobe) at 24^2, 1 sample a pixel, two
bounces, seed 11: a soft sun (5 degrees: cone-sampled occlusion rays), a
soft spot (source radius 0.3: disk-jittered), a hard spot, a spot that
casts no shadow, a hard point, a soft point and a point that casts none,
so every key split of the reference's order is taken. Tolerance as in
test_torch_pathtracer.py: rtol 1e-4 / atol 1e-5 on at least 99 % of the
pixels, all finite (a bounce ray can flip its hit on an ulp).
"""

import numpy as np
import torch

from test_torch_pathtracer import assert_radiance_close

torch.set_num_threads(2)

RES = 24


def branch_scene(proc, lights):
    scene, cam = proc.build_flat_test_scene(viewport=(RES, RES))
    scene.sun.angular_radius_deg = 5.0
    scene.env_brightness = 0.0
    down = np.array([0.0, -1.0, 0.0], np.float32)
    for pos, casts, radius in (((-1.5, 3.5, 0.5), True, 0.3), ((1.0, 3.0, 1.0), True, 0.0),
                               ((0.0, 3.0, -1.0), False, 0.0)):
        scene.spots.append(lights.SpotLight(
            position=np.array(pos, np.float32), direction=down, luminous_intensity_cd=40000.0,
            outer_cone_angle=np.radians(50.0), inner_cone_angle=np.radians(30.0),
            cast_shadows=casts, source_radius=radius))
    for pos, casts, radius in (((2.0, 2.0, 2.0), True, 0.0), ((-2.5, 1.8, 1.5), True, 0.25),
                               ((0.5, 2.5, 2.5), False, 0.0)):
        scene.points.append(lights.PointLight(
            position=np.array(pos, np.float32), luminous_intensity_cd=15000.0,
            cast_shadows=casts, source_radius=radius))
    return scene, cam


def test_trace_path_branches_match_jax():
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_torch.scene.lights as tlights
    import arkoserenderer_tpu.assets.procedural as jproc
    import arkoserenderer_tpu.scene.lights as jlights
    from arkoserenderer_torch.models.pathtracer import PathTracer as TPathTracer
    from arkoserenderer_torch.ops import bvh_cuda
    from arkoserenderer_tpu.models.pathtracer import PathTracer as JPathTracer

    js, jc = branch_scene(jproc, jlights)
    ts, tc = branch_scene(tproc, tlights)
    ref = np.asarray(JPathTracer(js, jc, RES, RES, max_bounces=2, seed=11).render_sample(1))
    t = TPathTracer(ts, tc, RES, RES, max_bounces=2, seed=11, device="cpu")
    assert t._lights["spot_casters"] == (True, True, False)
    assert t._lights["point_source_radius"] == (0.0, 0.25, 0.0)
    assert t._lights["sun_cos_radius"] < 1.0
    ours = t.render_sample(1).numpy()
    assert_radiance_close(ours, ref)
    assert ref.max() > 0.05
    assert bvh_cuda.trace_rays_cuda.launches == 0  # CPU tensors take the plain walk
