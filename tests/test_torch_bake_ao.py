"""``bake_vertex_ao`` (``ops/bake_ao``) against the JAX package's: the test
scene's vertex pool (its capacity cut to 2,048 vertices, which the scene's
1,003 fill) baked with 8 rays a hemisphere, 16 traces, from the port's own
build and from the reference's carried across: AO and bent normals to
1e-5.
"""

import numpy as np
import torch

from arkoserenderer_torch.core.types import SceneLimits as TSceneLimits
from arkoserenderer_tpu.core.types import SceneLimits as JSceneLimits

torch.set_num_threads(2)


def test_bake_vertex_ao_matches_jax():
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_tpu.assets.procedural as jproc
    from arkoserenderer_torch import bridge
    from arkoserenderer_torch.ops.bake_ao import bake_vertex_ao as t_bake
    from arkoserenderer_tpu.ops.bake_ao import bake_vertex_ao as j_bake

    lim = dict(max_vertices=1 << 11, max_indices=3 << 11, max_drawables=64, max_materials=32,
               max_textures=32, texture_pool_texels=1 << 19)
    js, _ = jproc.build_test_scene(limits=JSceneLimits(**lim), viewport=(32, 32))
    ts, _ = tproc.build_test_scene(limits=TSceneLimits(**lim), viewport=(32, 32))
    ja = js.build(with_bvh=True)
    jao, jbent = j_bake(ja, num_rays=8)
    # The port's own build and the reference's carried across agree.
    for arrays in (ts.build("cpu", with_bvh=True),
                   bridge.scene_arrays_from_numpy(ja._asdict(), "cpu")):
        tao, tbent = t_bake(arrays, num_rays=8)
        assert tao.shape == (1 << 11,) and tbent.shape == (1 << 11, 3)
        np.testing.assert_allclose(tao, jao, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tbent, jbent, atol=1e-5, rtol=0)
    assert (tao >= 0).all() and (tao <= 1).all()
    assert 0.05 < (tao < 0.999).mean() < 0.95  # the floor under the spheres is occluded
