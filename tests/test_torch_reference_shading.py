"""The port's reference shading mode (``shading_mode="reference"``) against
the JAX package's: the per-field VisibilityShading
(``ops/shading.shade_visibility_buffer``) with no geom.vtx_world, no
vis.records and no VSM moments (the sun by PCF taps of its map).

Pass by pass at 96^2, the walk of test_torch_passes.py (each torch pass
fed the JAX input state of that pass): the forward frame (TAA and Bloom)
with trilinear and with bilinear textures, the test_spot frame (a
shadow-casting spot: LocalShadow and its PCF) and the rt frame (the RT sun
and spot masks, RTReflections). (test_torch_reference_frames.py holds the
whole frames and the refused configuration.)

Tolerances are test_torch_passes.py's and test_torch_rt.py's. Bilinear filtering
rounds the LOD to a mip, a hard threshold: a pixel whose LOD lies within
an ulp of a .5 tie may pick the other mip in one package. Such pixels are
found from JAX's LOD, must be under 0.1 % of the frame, and every pixel
where the shaded resources differ must be one of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_bvh import rt_scene
from test_torch_passes import FLIPS, RASTER, RES, _np, _torch_state, compare, compare_flips
from test_torch_rt import compare_rt

torch.set_num_threads(2)

SIZES = dict(width=RES, height=RES, shadow_map_size=128, local_shadow_map_size=128)
# case -> (scene kind, make_forward_pipeline flags, PipelineConfig fields, passes)
CASES = {
    "forward": ("test", {}, {"texture_quality": "trilinear"},
                ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
                 "SkyView", "Bloom", "TAA", "Output"]),
    "forward_bilinear": ("test", {}, {"texture_quality": "bilinear"},
                         ["Scene", "Geometry", "SunShadow", "VisibilityShading",
                          "LightingCompose", "SkyView", "Bloom", "TAA", "Output"]),
    "test_spot": ("spot", {}, {},
                  ["Scene", "Geometry", "SunShadow", "LocalShadow", "VisibilityShading",
                   "LightingCompose", "SkyView", "Bloom", "TAA", "Output"]),
    "rt": ("spot", dict(rt_shadows=True, rt_reflections=True), {},
           ["Scene", "Geometry", "RTShadow", "RTLocalShadow", "VisibilityShading",
            "RTReflections", "LightingCompose", "SkyView", "Bloom", "TAA", "Output"]),
}
# Resources only the packed mode publishes.
PACKED_ONLY = {"geom.vtx_world", "vis.records", "ShadowMoments.sun"}


def build(kind: str, pkg: str, res: int = RES):
    import importlib

    root = {"jax": "arkoserenderer_tpu", "torch": "arkoserenderer_torch"}[pkg]
    proc = importlib.import_module(f"{root}.assets.procedural")
    if kind == "spot":
        return rt_scene(proc, importlib.import_module(f"{root}.scene.lights"), res)
    return proc.build_test_scene(viewport=(res, res))


def walk(case: str) -> dict:
    """Both reference-mode pipelines of ``case`` pass by pass over one frame:
    {pass: (torch updates, jax updates)}, and the two pipelines."""
    kind, flags, fields, passes = CASES[case]
    jscene, jcam = build(kind, "jax")
    tscene, _ = build(kind, "torch")
    common = dict(SIZES, shading_mode="reference", **fields)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jscene.static_info(), **common)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **common)
    jpipe = j_make_pipeline(jcfg, **flags)
    tpipe = t_make_pipeline(tcfg, device="cpu", **flags)
    assert [n for n, _ in jpipe._executes] == passes == [n for n, _ in tpipe._executes]
    assert sorted(jpipe.registry.persistent_names) == sorted(tpipe.registry.persistent_names)
    jsa = jscene.build(with_bvh=bool(flags))
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    jcs = jcam.state(0)
    tctx = TFrameContext(scene=tsa, camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                         frame_index=0, delta_time=1 / 60)
    jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(0, jnp.int32),
                         delta_time=jnp.asarray(1 / 60, jnp.float32),
                         row_offset=jnp.zeros((), jnp.int32))
    state = jpipe.initial_state()
    state["scene.version"] = jnp.asarray(0, jnp.int32)
    out = {}
    for (name, jexec), (_, texec) in zip(jpipe._executes, tpipe._executes):
        tupd = texec(_torch_state(state), tctx)
        jupd = jax.jit(jexec)(state, jctx)
        out[name] = (tupd, jupd)
        state = {**state, **jupd}
    return out, tpipe, (jsa, jcs)


def mip_ties(jsa, vis, setup, tol: float = 1e-4) -> np.ndarray:
    """(H, W) bool: covered pixels whose JAX LOD of their material's base
    texture lies within ``tol`` of a .5 tie, where nearest-mip rounding
    can go either way between the packages."""
    from arkoserenderer_tpu.ops import interpolate as jip
    from arkoserenderer_tpu.ops import texture as jtx

    xs = np.arange(RES, dtype=np.float32) + 0.5
    px, py = (jnp.asarray(a.ravel()) for a in np.meshgrid(xs, xs))
    geom = jip.pixel_barycentrics(jnp.asarray(vis).reshape(-1), setup, jsa.indices, px, py)
    _, dx, dy = jip.interpolate_with_grad(jsa.uvs, geom)
    mat = jsa.inst_material[jsa.tri_instance[geom.tri]]
    lod = np.asarray(jtx.compute_lod(jsa.textures, jsa.materials.base_color_tex[mat], dx, dy))
    frac = lod - np.floor(lod)
    return (np.asarray(geom.valid) & (np.abs(frac - 0.5) < tol)).reshape(RES, RES)


@pytest.fixture(scope="module", params=sorted(CASES))
def walked(request):
    return request.param, *walk(request.param)


def test_reference_mode_matches_jax(walked):
    """Every published key of every pass, the G-buffer of the per-field
    VisibilityShading among them."""
    case, out, _, (jsa, _) = walked
    geo_t, geo_j = out["Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    for name in CASES[case][3]:
        tupd, jupd = out[name]
        assert set(tupd) == set(jupd), name
        agree = vis_agree
        if name == "VisibilityShading" and case == "forward_bilinear":
            ties = mip_ties(jsa, geo_j["Visibility"], geo_j["vis.setup"])
            assert ties.mean() < 0.001
            diff = np.abs(_np(tupd["SceneBaseColor"]) - _np(jupd["SceneBaseColor"])).max(-1)
            assert ties[vis_agree & (diff > 1e-4)].all()
            agree = vis_agree & ~ties
        for key in sorted(jupd):
            flips = FLIPS.get(("spot" if case == "test_spot" else case, name, key))
            if flips is not None:
                compare_flips(key, tupd[key], jupd[key], *flips)
            elif not compare_rt(key, tupd[key], jupd[key], agree):
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else agree)
    ldr = _np(out["Output"][0]["LDR"])
    assert np.isfinite(ldr).all() and ldr.std() > 0.05


def test_reference_mode_publishes_no_packed_resources(walked):
    """The reference mode builds neither the world-space pool nor the
    shading records nor the sun's moments; its shading reads the object
    pools, the raster setup and (mapped shadows) the sun's depth map."""
    case, out, tpipe, _ = walked
    published = set().union(*(set(t) for t, _ in out.values()))
    assert not published & PACKED_ONLY
    reads = tpipe.registry
    assert {"geom.positions", "geom.normals", "geom.tangents", "vis.setup"} <= published
    if case == "rt":
        assert "ShadowMask.sun" in published and "ShadowMap.sun" not in published
    else:
        assert "ShadowMap.sun" in published
    assert reads.has("SceneColor")
