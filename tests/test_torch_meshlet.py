"""The port's meshlets against the JAX package's: ``build_meshlets`` on the
stress scene's two LOD segments and the test scene's segments, the meshlet
arrays of ``Scene.build``, and Geometry's meshlet culling in the animated
stress frame (every pass over two frames, as tests/test_torch_stress.py
walks it without meshlets).

Tolerances: meshlet offsets, counts, the triangle-to-meshlet map, the
owning instances and the valid flags equal; sphere and cone bounds to 1e-6
(the reference may build them in its native library, which sums in double;
the port sums the NumPy way in float32). The frame walk is held by
tests/test_torch_stress.py's rules. Culling is conservative, so the port's
frame with meshlets has the same Visibility and SceneDepth, bit for bit, as
its frame without them on the same inputs (the reference's claim,
tests/test_meshlet_culling.py:17).
"""

import dataclasses

import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets import meshopt as tmeshopt
from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_torch.core import mathx as mx
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.rendering.passes.geometry import meshlet_visible
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.assets import meshopt as jmeshopt
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene
from test_torch_scene import assert_field_equal
from test_torch_stress import (
    RASTER,
    assert_visibility_exact,
    assert_walk_matches,
    both_stress,
    walk_animated,
)

torch.set_num_threads(2)

def _segments():
    js, _, ts, _ = both_stress()
    jt, _ = j_build_test_scene()
    tt, _ = t_build_test_scene()
    return [(f"stress {i}", a, b) for i, (a, b) in enumerate(zip(js.segments, ts.segments))] + [
        (f"test {i}", a, b) for i, (a, b) in enumerate(zip(jt.segments, tt.segments))]


@pytest.mark.parametrize("limits", [(64, 126), (32, 40)])
def test_build_meshlets_matches_jax(limits):
    """Every segment of both scenes, at the reference's limits (64 vertices,
    126 triangles) and tighter ones."""
    max_verts, max_tris = limits
    for name, jseg, tseg in _segments():
        ref = jmeshopt.build_meshlets(jseg.positions, jseg.indices, max_verts, max_tris)
        ours = tmeshopt.build_meshlets(tseg.positions, tseg.indices, max_verts, max_tris)
        assert ours.count == ref.count > 0, name
        np.testing.assert_array_equal(ours.tri_offset, ref.tri_offset, err_msg=name)
        np.testing.assert_array_equal(ours.tri_count, ref.tri_count, err_msg=name)
        assert ours.tri_count.sum() == tseg.num_triangles and ours.tri_count.max() <= max_tris
        np.testing.assert_allclose(ours.sphere, ref.sphere, atol=1e-6, rtol=0, err_msg=name)
        np.testing.assert_allclose(ours.cone, ref.cone, atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("scene", ["stress", "test"])
def test_meshlet_arrays_match_jax(scene):
    """Scene.build with enable_meshlets: the meshlet fields (and every other
    pool) equal JAX's; every valid triangle belongs to a meshlet of its own
    instance; without meshlets, the reference's placeholder rows."""
    if scene == "stress":
        js, _, ts, _ = both_stress(meshlets=True)
    else:
        (js, _), (ts, _) = j_build_test_scene(), t_build_test_scene()
        js.enable_meshlets = ts.enable_meshlets = True
    ref = bridge.numpy_fields(js.build())
    ours = bridge.numpy_fields(ts.build("cpu"))
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    assert ts.static_info().has_meshlets and js.static_info().has_meshlets
    valid = ours["tri_valid"]
    np.testing.assert_array_equal(ours["meshlet_instance"][ours["tri_meshlet"][valid]],
                                  ours["tri_instance"][valid])
    assert ours["meshlet_valid"].all() and (ours["meshlet_sphere"][:, 3] > 0).all()
    ts.enable_meshlets = False
    bare = ts.build("cpu")
    assert bare.meshlet_valid.tolist() == [False] and bare.meshlet_cone.tolist() == [[0, 0, 1, -1]]
    assert not bare.tri_meshlet.any()


@pytest.fixture(scope="module")
def meshlet_walk():
    return walk_animated(meshlets=True)


@pytest.mark.parametrize("frame", [0, 1])
def test_meshlet_frame_matches_jax(meshlet_walk, frame):
    """Every published key of every pass of the animated stress frame with
    meshlet culling, and Visibility bit for bit from the JAX setup."""
    assert_walk_matches(meshlet_walk, frame)
    assert_visibility_exact(meshlet_walk, frame)


@pytest.mark.parametrize("scene", ["stress", "test"])
def test_meshlet_culling_keeps_the_image(scene):
    """The port's Geometry with meshlets against its Geometry without them,
    on one scene and camera: the meshlet test drops meshlets (and their
    triangles) yet Visibility and SceneDepth are equal bit for bit."""
    if scene == "stress":
        _, _, ts, tc = both_stress(meshlets=True)
        res = 128
    else:
        ts, tc = t_build_test_scene(viewport=(96, 96))
        ts.enable_meshlets = True
        res = 96
    tsa = ts.build("cpu")
    cam = tc.state(0, "cpu")
    cfg = TPipelineConfig(width=res, height=res, shadow_map_size=128,
                          raster=TRasterConfig(**RASTER))
    ctx = TFrameContext(scene=tsa, camera=cam, frame_index=0, delta_time=1 / 60)
    outs = {}
    for meshlets in (True, False):
        st = dataclasses.replace(ts.static_info(), has_meshlets=meshlets)
        pipe = t_make_pipeline(dataclasses.replace(cfg, scene=st), device="cpu", taa=False,
                               bloom=False, shadows=False)
        state = pipe.initial_state()
        for name, execute in pipe._executes[:2]:
            state.update(execute(state, ctx))
        outs[meshlets] = state
    for key in ("Visibility", "SceneDepth"):
        assert torch.equal(outs[True][key], outs[False][key]), key
    assert (outs[True]["Visibility"] >= 0).any()
    kept = meshlet_visible(tsa, mx.frustum_planes_from_matrix(cam.view_proj), cam.position)
    assert 0 < int(kept.sum()) < int(tsa.meshlet_valid.sum())
