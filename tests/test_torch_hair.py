"""Hair, the port against the JAX package: ``Scene.add_hair``, the Scene
pass's camera-facing ribbons, every pass of the hair frame, the .arkhair
loader (alone and named by a level object) and the humandemo app.

The hair scene is tests/test_hair_ao.py's: the test scene with one sphere
and 24 six-point strands of radius 0.02, at 96^2.

Tolerances:
  * the build's arrays (the hair rows, the ribbon segment, the BVH with the
    hair instance's own BLAS) and ``static_info``: test_torch_scene.py's
    (ints equal, floats to 1e-6);
  * the pass walk (test_torch_passes.py's harness and bounds: each torch
    pass gets the JAX input state of that pass), over two frames with the
    camera moved between them; the ribbon rows of geom.positions,
    geom.normals and geom.tangents to 1e-6 (a normalize and a cross of f32
    values, which XLA:CPU may fuse), the other rows equal; geom.vtx_world,
    whose record layout keeps the previous-position lanes under hair, to
    the geometry bound (rtol 1e-5, atol 1e-5);
  * the humandemo app's PNG against the JAX app's under the goldens' bound
    (mean abs diff < 1.5, under 0.5 % of values off by more than 24).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arkoserenderer_torch.assets.procedural as tproc
import arkoserenderer_torch.scene.scene as tscene
import arkoserenderer_tpu.assets.procedural as jproc
import arkoserenderer_tpu.scene.scene as jscene
from arkoserenderer_torch import bridge
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import make_forward_pipeline as t_make_pipeline
from arkoserenderer_torch.rendering.passes.scenepass import hair_ribbons
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.models.standard import make_forward_pipeline as j_make_pipeline
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from test_torch_passes import RASTER, RES, _np, _torch_state, compare
from test_torch_scene import assert_field_equal

torch.set_num_threads(2)

PASSES = ["Scene", "Geometry", "SunShadow", "VisibilityShading", "LightingCompose",
          "SkyView", "Output"]
RIBBON = ("geom.positions", "geom.normals", "geom.tangents")


def add_test_hair(mod, scene, n_strands=24):
    """tests/test_hair_ao.py's strands, with ``mod``'s Material."""
    rng = np.random.default_rng(3)
    pts, segs = [], []
    for _ in range(n_strands):
        root = np.array([rng.uniform(-0.5, 0.5), 1.2, rng.uniform(-0.5, 0.5)])
        pts.extend(root + np.array([0, -0.12 * i, 0.02 * i * i]) for i in range(6))
        segs.append(5)
    mat = scene.add_material(mod.Material(
        base_color_factor=np.array([0.35, 0.22, 0.08, 1.0], np.float32),
        roughness_factor=0.5, double_sided=True))
    return scene.add_hair(np.array(pts, np.float32), np.array(segs), material=mat, radius=0.02)


def hair_scene(pkg):
    proc, mod = (jproc, jscene) if pkg == "jax" else (tproc, tscene)
    scene, cam = proc.build_test_scene(viewport=(RES, RES), n_spheres=1)
    add_test_hair(mod, scene)
    return scene, cam


def test_add_hair_matches_jax():
    """The hair rows, the ribbon segment's indices, the instance's bounds,
    the BVH (with the hair instance's own world-space BLAS) and the
    static facts (has_hair, hair_vertex_base) equal JAX's."""
    (js, _), (ts, _) = hair_scene("jax"), hair_scene("torch")
    ref = bridge.numpy_fields(js.build(with_bvh=True))
    ours = bridge.numpy_fields(ts.build("cpu", with_bvh=True))
    assert {"hair_points", "hair_tangents", "hair_radius"} <= set(ours) <= set(ref)
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])
    assert ours["hair_points"].shape == (24 * 6, 3) and (ours["hair_radius"] == 0.02).all()
    st, sj = ts.static_info(), js.static_info()
    for f in type(st).__dataclass_fields__:
        assert getattr(st, f) == getattr(sj, f), f
    assert st.has_hair and st.hair_vertex_base == sum(
        ts.segments[sid].positions.shape[0] for sid, *_ in ts.instances[:-1])
    with pytest.raises(ValueError, match="one hair batch"):
        add_test_hair(tscene, ts)


@pytest.mark.parametrize("base", [0, 5, 10_000])
def test_ribbon_rows_clamp_like_dynamic_update_slice(base):
    """The ribbon rows land where jax.lax.dynamic_update_slice_in_dim puts
    them, its start clamped to the pool's end."""
    rng = np.random.default_rng(base)
    pts = rng.normal(size=(8, 3)).astype(np.float32)
    tan = rng.normal(size=(8, 3)).astype(np.float32)
    rad = rng.uniform(0.01, 0.05, 8).astype(np.float32)
    pool = rng.normal(size=(40, 3)).astype(np.float32)
    eye = np.array([0.3, 2.0, 4.0], np.float32)
    scene = type("S", (), {"hair_points": torch.from_numpy(pts),
                           "hair_tangents": torch.from_numpy(tan / np.linalg.norm(tan, axis=1,
                                                                                keepdims=True)),
                           "hair_radius": torch.from_numpy(rad)})
    p, _, _ = hair_ribbons(scene, torch.from_numpy(eye), torch.from_numpy(pool),
                           torch.from_numpy(pool), torch.from_numpy(np.tile(pool, (1, 2))[:, :4]),
                           base)
    start = min(base, 40 - 16)
    rows = p.numpy()[start:start + 16]
    ref = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(pool), jnp.asarray(rows), base, 0)
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(np.delete(p.numpy(), np.s_[start:start + 16], 0),
                                  np.delete(pool, np.s_[start:start + 16], 0))


@pytest.fixture(scope="module")
def hair_walk():
    """Both pipelines on the hair scene pass by pass over two frames, the
    camera moved 0.3 along x for frame 1: {(frame, pass): (torch, jax)}."""
    jsc, jcam = hair_scene("jax")
    tsc, _ = hair_scene("torch")
    sizes = dict(width=RES, height=RES, shadow_map_size=128)
    jcfg = JPipelineConfig(raster=JRasterConfig(**RASTER), scene=jsc.static_info(), **sizes)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tsc.static_info(), **sizes)
    jpipe = j_make_pipeline(jcfg, taa=False, bloom=False)
    tpipe = t_make_pipeline(tcfg, taa=False, bloom=False, device="cpu")
    assert [n for n, _ in jpipe._executes] == PASSES == [n for n, _ in tpipe._executes]
    # Hair is not cacheable: the sun map is rastered every frame.
    assert "ShadowMap.sun" not in jpipe.registry.persistent_names
    assert "ShadowMap.sun" not in tpipe.registry.persistent_names
    jsa = jsc.build()
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    jitted = [jax.jit(jexec) for _, jexec in jpipe._executes]
    state, out = jpipe.initial_state(), {}
    for f in (0, 1):
        if f == 1:
            jcam.post_render()
            jcam.position = jcam.position + np.array([0.3, 0.0, 0.0], np.float32)
            state = {k: state[k] for k in jpipe.registry.persistent_names}
        jcs = jcam.state(f)
        tctx = TFrameContext(scene=tsa, camera=bridge.camera_state_from_numpy(jcs._asdict(),
                                                                              "cpu"),
                             frame_index=f, delta_time=1 / 60)
        jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(f, jnp.int32),
                             delta_time=jnp.asarray(1 / 60, jnp.float32),
                             row_offset=jnp.zeros((), jnp.int32))
        for (name, _), jexec, (_, texec) in zip(jpipe._executes, jitted, tpipe._executes):
            tupd = texec(_torch_state(state), tctx)
            jupd = jexec(state, jctx)
            out[f, name] = (tupd, jupd)
            state = {**state, **jupd}
    return tsc, out


@pytest.mark.parametrize("frame", [0, 1])
def test_hair_frame_passes_match_jax(hair_walk, frame):
    """Every resource every pass publishes, hair ribbons on screen."""
    scene, out = hair_walk
    base = scene.static_info().hair_vertex_base
    rows = slice(base, base + 2 * 24 * 6)
    geo_t, geo_j = out[frame, "Geometry"]
    vis_agree = _np(geo_t["Visibility"]) == _np(geo_j["Visibility"])
    for name in PASSES:
        tupd, jupd = out[frame, name]
        assert set(tupd) == set(jupd), name
        for key in sorted(jupd):
            if key in RIBBON:
                o, r = _np(tupd[key]), _np(jupd[key])
                np.testing.assert_allclose(o[rows], r[rows], rtol=0, atol=1e-6, err_msg=key)
                np.testing.assert_array_equal(np.delete(o, rows, 0), np.delete(r, rows, 0))
            else:
                compare(key, tupd[key], jupd[key], None if name == "Geometry" else vis_agree)
    # The record layout keeps the previous-position lanes: wpos, prev, nrm, uv.
    assert _np(out[frame, "Scene"][0]["geom.vtx_world"]).shape[1] == 3 + 3 + 3 + 2
    vis = _np(geo_t["Visibility"])
    orig = _np(geo_t["vis.setup"].orig_tri)[vis[vis >= 0]]
    hair_inst = len(scene.instances) - 1
    assert (np.asarray(scene.build_host()["tri_instance"])[orig] == hair_inst).sum() > 20
    assert np.isfinite(_np(out[frame, "Output"][0]["LDR"])).all()


def test_hair_ribbons_face_the_moving_camera(hair_walk):
    """The ribbons are placed anew for frame 1's camera."""
    scene, out = hair_walk
    base = scene.static_info().hair_vertex_base
    p0, p1 = (_np(out[f, "Scene"][0]["geom.positions"])[base:base + 288] for f in (0, 1))
    assert np.abs(p1 - p0).max() > 1e-4
    mid = 0.5 * (p0[0::2] + p0[1::2])
    np.testing.assert_allclose(mid, _np(bridge.numpy_fields(
        scene.build("cpu"))["hair_points"]), atol=1e-6)


def test_load_arkhair_matches_jax(tmp_path):
    """.arkhair into both packages' scenes (alone, and named by a level
    object with its transform): every built array equal, and the loader's
    counts too."""
    from arkoserenderer_torch.assets import ark as tark
    from arkoserenderer_torch.core.types import SceneLimits as TLimits
    from arkoserenderer_torch.tools.ark_level import write_level
    from arkoserenderer_tpu.assets import ark as jark
    from arkoserenderer_tpu.core.types import SceneLimits as JLimits

    limits = dict(max_vertices=1 << 14, max_indices=3 << 14, max_drawables=64,
                  max_materials=16, max_textures=16, texture_pool_texels=1 << 16)
    rng = np.random.default_rng(1)
    pts, segs = rng.normal(size=(10, 3)).astype(np.float32), np.array([4, 4])
    tark.save_arkhair(tmp_path / "t.arkhair", pts, segs,
                      thickness=rng.uniform(0.01, 0.04, 10).astype(np.float32))
    ts, js = tscene.Scene(TLimits(**limits)), jscene.Scene(JLimits(**limits))
    rt, rj = (mod.load_arkhair(s, tmp_path / "t.arkhair")
              for mod, s in ((tark, ts), (jark, js)))
    assert rt == rj and rt["strands"] == 2 and rt["points"] == 10
    ours, ref = bridge.numpy_fields(ts.build("cpu")), bridge.numpy_fields(js.build())
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])

    paths = write_level(tmp_path / "tree")
    hair = paths["level"].parent / "strands.arkhair"
    tark.save_arkhair(hair, pts, segs, thickness=0.02)
    doc = json.loads(Path(paths["level"]).read_text())
    doc["level"]["objects"][1]["hair"] = "assets/strands.arkhair"
    level = Path(paths["level"]).with_name("hairy.arklvl")
    level.write_text(json.dumps(doc))
    ts, js = tscene.Scene(TLimits(**limits)), jscene.Scene(JLimits(**limits))
    lt, lj = tark.load_arklvl(ts, level), jark.load_arklvl(js, level)
    assert lt["instances"] == lj["instances"] and lt["missing"] == lj["missing"] == []
    assert ts.static_info().has_hair and js.static_info().has_hair
    ours, ref = bridge.numpy_fields(ts.build("cpu")), bridge.numpy_fields(js.build())
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])


# The app's defaults, and without SSSS and hair (camera orbiting).
HUMAN = {"default": [], "no-ssss-no-hair": ["--no-ssss", "--no-hair", "--orbit"]}


@pytest.mark.parametrize("case", sorted(HUMAN))
def test_humandemo_matches_the_jax_app(case, tmp_path):
    """The app's argv at 64^2, 2 frames, through both packages' apps: the
    PNGs within the goldens' bound; the port's Renderer has the
    reference's passes (SSSS unless --no-ssss) and, with hair, hair
    pixels on screen."""
    from arkoserenderer_torch.apps import humandemo
    from arkoserenderer_torch.utils.imageio import load_png
    from arkoserenderer_tpu.apps.humandemo import main as jax_main

    argv = ["--width", "64", "--height", "64", "--frames", "2"] + HUMAN[case]
    ours_png, ref_png = tmp_path / "ours.png", tmp_path / "ref.png"
    r = humandemo.main(argv + ["--out", str(ours_png)], device="cpu")
    jax_main(argv + ["--out", str(ref_png)])
    ours, ref = load_png(str(ours_png)), load_png(str(ref_png))[..., :3]
    assert ours.shape == (64, 64, 3) and ours.std() > 5
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 1.5 and (diff > 24).mean() < 0.005, (diff.mean(), (diff > 24).mean())
    names = [p.name for p in r.pipeline.passes]
    assert ("SSSS" in names) == (case == "default")
    assert r.cfg.raster.tile_w == 16 and r.cfg.raster.max_tris_per_tile == 512
    assert r.cfg.shadow_map_size == 1024 and r.cfg.scene.has_hair == (case == "default")
    if case == "default":
        vis = r.state["Visibility"].numpy()
        orig = r.state["vis.setup"].orig_tri.numpy()[vis[vis >= 0]]
        assert (r.scene_arrays.tri_instance.numpy()[orig] == len(r.scene.instances) - 1).any()
