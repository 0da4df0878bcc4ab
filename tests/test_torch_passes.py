"""Per-pass parity of the port's forward frame with the JAX package's, at 96^2.

The harness walks the JAX pipeline's passes in order (the walk of
``validate_frame``, each pass jitted on its own), feeds every torch pass the
JAX input state of that pass through the bridge, and compares every
resource the pass publishes. Each pass is held on its own, so differences
cannot compound from one pass to the next.

Tolerances (both sides are f32; XLA:CPU fuses and reassociates some
multiply-adds and evaluates pow/log/exp/sin with its own approximations,
eager torch rounds every operation and calls libm):
  * ids, masks, counters and host versions: equal;
  * Visibility: equal background masks, under 0.1 % of ids differing
    (exact depth ties between the two rasters);
  * depths (SceneDepth, ShadowMap.sun, ShadowMoments.sun): atol 1e-6;
  * geometry floats (vertex pool, setup, records): rtol 1e-5, atol 1e-5 —
    relative, because off-screen corners of clipped triangles sit
    thousands of pixels out, where one f32 ulp is ~2e-4;
  * colour resources: compared only where Visibility agrees, to the max-abs
    bound in COLOR_ATOL (a few hundred ulps of the resource's own scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.ops.raster import TriSetup as TTriSetup
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

RES = 96
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
PASSES = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
          "SkyView", "Output"]

EXACT = {"geom.positions", "geom.normals", "geom.tangents", "vis.overflow",
         "SceneCoverage", "scene.version", "SunShadow.version"}
DEPTHS = {"SceneDepth", "ShadowMap.sun", "ShadowMoments.sun"}
GEOMETRY = {"geom.vtx_world", "vis.setup", "vis.records"}
COLOR_ATOL = {
    "SceneColor": 2e-4,       # pre-exposed HDR, values up to ~2
    "SceneNormal": 1e-5,      # unit vectors
    "SceneVelocity": 5e-4,    # pixels: the difference of two ~100 px
                              # positions (one ulp there is 7.6e-6)
    "SceneBaseColor": 1e-4,   # trilinear albedo in [0, 1]: the mip lerp
                              # weight comes from a log2 of the UV gradients
    "SceneMaterial": 1e-5,    # roughness, metallic, occlusion, subsurface
    "LDR": 1e-5,              # display-encoded [0, 1]
    "Metering.avgLum": 1e-5,  # scalar, ~0.3
}


def _torch_state(state: dict) -> dict:
    """The JAX frame state as the port holds it (copies, on the CPU)."""
    out = {}
    for k, v in state.items():
        if k in ("scene.version", "SunShadow.version"):
            out[k] = int(np.asarray(v))   # host values in the port
        elif hasattr(v, "_fields"):       # the raster setup NamedTuple
            out[k] = TTriSetup(*(torch.from_numpy(np.array(x)) for x in v))
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def compare(key, ours, ref, vis_agree):
    if key == "Visibility":
        a, b = _np(ours), _np(ref)
        np.testing.assert_array_equal(a == -1, b == -1)
        assert (a != b).mean() < 0.001, key
    elif key in EXACT:
        assert np.array_equal(_np(ours), _np(ref)), key
    elif key in DEPTHS:
        np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-6, rtol=0, err_msg=key)
    elif key in GEOMETRY:
        pairs = zip(ours, ref) if key == "vis.setup" else [(ours, ref)]
        for o, r in pairs:
            o, r = _np(o), _np(r)
            if np.issubdtype(r.dtype, np.floating):
                np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=key)
            else:
                np.testing.assert_array_equal(o, r, err_msg=key)
    else:
        o, r = _np(ours), _np(ref)
        if o.ndim >= 2 and vis_agree is not None:
            o, r = o[vis_agree], r[vis_agree]
        np.testing.assert_allclose(o, r, atol=COLOR_ATOL[key], rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def walk():
    """Run both pipelines pass by pass; returns {pass: (torch, jax) updates}."""
    jscene, jcam = j_build_test_scene(viewport=(RES, RES))
    tscene, _ = t_build_test_scene(viewport=(RES, RES))
    jcfg = JPipelineConfig(width=RES, height=RES, raster=JRasterConfig(**RASTER),
                           shadow_map_size=128, scene=jscene.static_info())
    tcfg = TPipelineConfig(width=RES, height=RES, raster=TRasterConfig(**RASTER),
                           shadow_map_size=128, scene=tscene.static_info())
    jpipe = j_make_pipeline(jcfg, taa=False, bloom=False)
    tpipe = t_make_pipeline(tcfg, taa=False, bloom=False, device="cpu")
    assert [n for n, _ in jpipe._executes] == PASSES == [n for n, _ in tpipe._executes]
    assert sorted(jpipe.registry.persistent_names) == sorted(tpipe.registry.persistent_names)

    jsa, jcs = jscene.build(), jcam.state(0)
    tctx = TFrameContext(
        scene=bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu"),
        camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
        frame_index=0, delta_time=1 / 60,
    )
    jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(0, jnp.int32),
                         delta_time=jnp.asarray(1 / 60, jnp.float32),
                         row_offset=jnp.zeros((), jnp.int32))
    state = jpipe.initial_state()
    state["scene.version"] = jnp.asarray(0, jnp.int32)  # the first build, as Renderer
    out = {}
    for (name, jexec), (_, texec) in zip(jpipe._executes, tpipe._executes):
        tupd = texec(_torch_state(state), tctx)
        jupd = jax.jit(jexec)(state, jctx)
        out[name] = (tupd, jupd)
        state = {**state, **jupd}
    return out


@pytest.mark.parametrize("name", PASSES)
def test_pass_matches_jax(walk, name):
    tupd, jupd = walk[name]
    assert set(tupd) == set(jupd)
    vis_agree = None
    geo_t, geo_j = walk["Geometry"]
    if name != "Geometry":
        vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    for key in sorted(jupd):
        compare(key, tupd[key], jupd[key], vis_agree)
    if name == "Output":
        assert np.isfinite(_np(tupd["LDR"])).all()
