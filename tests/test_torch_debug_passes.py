"""The debug overlay passes, the port against the JAX package:
DebugVisualizePass in its 11 modes, DebugDraw (with lines that cross, so
samples of different colours share pixels), IconBillboards and
DDGIProbeDebug, and the showcase app's --debug-draw, --light-icons and
--ddgi-probe-debug.

Each pass gets the same input state in both packages: frame resources made
from a numpy seed (LDR, SceneDepth, the G-buffer channels, Visibility and
the setup rows' triangle ids, the DDGI irradiance atlas), the camera state
of one camera and the lights of one scene build, carried across by the
bridge. The pass runs once in each package (JAX's execute under jit, as
its frame runs it).

Tolerances:
  * LDR equal, bit for bit, for every pass but DDGIProbeDebug: where
    overlay samples share a pixel, both keep the last update (the
    reference's in-order scatter, the port's ``overlay.scatter_last``), and
    the projections round alike here;
  * DDGIProbeDebug: the disc colours are a mean over each probe's atlas
    tile, which the two packages sum in another order: 1e-6, and the
    covered pixels equal;
  * the showcase app's PNGs at 64^2 against the JAX app's: the goldens'
    bound (mean abs diff < 1.5, under 0.5 % of values off by more than 24).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arkoserenderer_tpu.scene.lights as jlights
from arkoserenderer_torch import bridge
from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_torch.ops.ddgi import ProbeGridConfig as TGrid
from arkoserenderer_torch.rendering.passes import ddgi_debug as tdd
from arkoserenderer_torch.rendering.passes import debugdraw as tdraw
from arkoserenderer_torch.rendering.passes import debugviz as tviz
from arkoserenderer_torch.rendering.passes import icons as ticons
from arkoserenderer_torch.rendering.passes.overlay import scatter_last
from arkoserenderer_torch.rendering.pipeline import FrameContext as TFrameContext
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.rendering.registry import Registry as TRegistry
from arkoserenderer_torch.scene.scene import SceneStatic as TStatic
from arkoserenderer_tpu.assets.procedural import build_test_scene as j_build_test_scene
from arkoserenderer_tpu.ops.ddgi import ProbeGridConfig as JGrid
from arkoserenderer_tpu.rendering.passes import ddgi_debug as jdd
from arkoserenderer_tpu.rendering.passes import debugdraw as jdraw
from arkoserenderer_tpu.rendering.passes import debugviz as jviz
from arkoserenderer_tpu.rendering.passes import icons as jicons
from arkoserenderer_tpu.rendering.pipeline import FrameContext as JFrameContext
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
from arkoserenderer_tpu.rendering.registry import Registry as JRegistry
from arkoserenderer_tpu.scene.scene import SceneStatic as JStatic

torch.set_num_threads(2)

H, W = 48, 64
N_TRI = 300


def _lights(mod):
    """Two spots and three points; two of the points project within a few
    pixels of each other, so their bulbs overlap."""
    spots = [mod.SpotLight(position=np.array([1.5, 2.0, 1.0], np.float32),
                           direction=np.array([0.0, -1.0, 0.0], np.float32),
                           color=np.array([1.0, 0.8, 0.2], np.float32)),
             mod.SpotLight(position=np.array([-1.0, 1.5, 0.5], np.float32),
                           direction=np.array([0.0, -1.0, 0.0], np.float32),
                           color=np.array([0.2, 0.4, 1.0], np.float32))]
    points = [mod.PointLight(position=np.array([0.0, 1.0, 0.0], np.float32),
                             color=np.array([1.0, 0.2, 0.1], np.float32)),
              mod.PointLight(position=np.array([0.05, 1.02, 0.0], np.float32),
                             color=np.array([0.1, 1.0, 0.3], np.float32)),
              mod.PointLight(position=np.array([0.5, 0.3, 2.5], np.float32),
                             color=np.array([0.0, 0.0, 0.0], np.float32))]
    return spots, points


@pytest.fixture(scope="module")
def inputs():
    """The same inputs for both packages: {"jax": (ctx, state), "torch":
    (ctx, state), "static": SceneStatic kwargs}."""
    rng = np.random.default_rng(13)
    js, jcam = j_build_test_scene(viewport=(W, H), n_spheres=1)
    js.spots, js.points = _lights(jlights)
    jsa = js.build()
    jcs = jcam.state(0)
    grid = JGrid(dims=(4, 2, 4), origin=(-3.0, 0.2, -3.0), spacing=(2.0, 1.2, 2.0))
    n_probes = grid.num_probes
    vis = rng.integers(-1, N_TRI, (H, W)).astype(np.int32)
    host = {
        "LDR": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        # Reverse-Z depths: most of the screen farther than the overlays,
        # a band nearer, which hides what crosses it.
        "SceneDepth": np.where(rng.uniform(size=(H, W)) < 0.8, 0.0,
                               rng.uniform(0, 1, (H, W))).astype(np.float32),
        "Visibility": vis,
        "SceneNormal": rng.normal(size=(H, W, 3)).astype(np.float32),
        "SceneVelocity": rng.normal(0, 6, (H, W, 2)).astype(np.float32),
        "SceneBaseColor": rng.uniform(0, 1.2, (H, W, 3)).astype(np.float32),
        "SceneMaterial": rng.uniform(0, 1.2, (H, W, 4)).astype(np.float32),
        "SSAO": rng.uniform(0, 1, (H, W)).astype(np.float32),
        "ShadowMask.sun": rng.uniform(0, 1, (H, W)).astype(np.float32),
        "DDGI.irradiance": rng.uniform(0, 0.4, (n_probes, 6, 6, 3)).astype(np.float32),
    }
    orig_tri = rng.integers(0, 4, N_TRI).astype(np.int32)  # the scene's first triangles
    jstate = {k: jnp.asarray(v) for k, v in host.items()}
    jstate["vis.setup"] = Setup(jnp.asarray(orig_tri))
    tstate = {k: torch.from_numpy(v.copy()) for k, v in host.items()}
    tstate["vis.setup"] = Setup(torch.from_numpy(orig_tri))
    tri_instance = np.array(jsa.tri_instance).copy()
    tri_instance[:4] = [0, 1, 2, 3]
    jsa = jsa._replace(tri_instance=jnp.asarray(tri_instance))
    jctx = JFrameContext(scene=jsa, camera=jcs, frame_index=jnp.asarray(0, jnp.int32),
                         delta_time=jnp.asarray(1 / 60, jnp.float32),
                         row_offset=jnp.zeros((), jnp.int32))
    tctx = TFrameContext(scene=bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu"),
                         camera=bridge.camera_state_from_numpy(jcs._asdict(), "cpu"),
                         frame_index=0, delta_time=1 / 60)
    static = dict(n_spots=2, n_points=3)
    return {"jax": (jctx, jstate), "torch": (tctx, tstate), "static": static, "grid": grid}


class Setup(NamedTuple):
    """The raster setup's field the passes read."""

    orig_tri: object


def run_pass(inputs, jpass, tpass, extra=None):
    """(port LDR, JAX LDR) of one pass over the fixture's inputs (and
    ``extra`` state by package)."""
    out = []
    for pkg, pss in (("torch", tpass), ("jax", jpass)):
        ctx, state = inputs[pkg]
        state = dict(state, **(extra or {}).get(pkg, {}))
        static = inputs["static"]
        if pkg == "torch":
            reg, cfg = TRegistry(), TPipelineConfig(width=W, height=H, scene=TStatic(**static))
        else:
            reg, cfg = JRegistry(), JPipelineConfig(width=W, height=H, scene=JStatic(**static))
        for name in state:
            if name != "debug.lines":  # DebugDraw publishes the host's input
                reg.publish(name)
        if pkg == "torch":
            out.append(pss.construct(cfg, reg, torch.device("cpu"))(state, ctx)["LDR"].numpy())
        else:
            execute = pss.construct(cfg, reg)
            out.append(np.asarray(jax.jit(lambda s, c: execute(s, c)["LDR"])(state, ctx)))
    return out


@pytest.mark.parametrize("mode", tviz.MODES)
def test_debug_visualize_mode_matches_jax(inputs, mode):
    assert tviz.MODES == jviz.MODES
    ours, ref = run_pass(inputs, jviz.DebugVisualizePass(mode), tviz.DebugVisualizePass(mode))
    assert ours.shape == ref.shape == (H, W, 3)
    np.testing.assert_array_equal(ours, ref)
    assert ours.min() >= 0.0 and ours.max() <= 1.0 and ours.std() > 0.01


def test_debug_visualize_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown debug mode"):
        tviz.DebugVisualizePass("albedo")


def _line_buffers():
    """The same lines in both packages' buffers: axes (which meet at the
    origin's pixel), a box, a ground grid and 200 random lines across the
    screen, in colours that differ line by line."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    bufs = []
    for mod in (tdraw, jdraw):
        buf = mod.DebugLineBuffer()
        buf.axes(size=1.5)
        buf.box(np.array([-1.0, 0.0, -1.0]), np.array([1.0, 1.4, 1.0]))
        buf.grid(size=4.0, step=1.0)
        for i in range(200):
            buf.line(a[i], b[i], colors[i])
        bufs.append(buf)
    return bufs


def test_debug_draw_matches_jax(inputs):
    """Lines over LDR, depth-tested, with many shared pixels: equal."""
    tbuf, jbuf = _line_buffers()
    assert tbuf.count == jbuf.count == 3 + 12 + 2 * 9 + 200
    extra = {"torch": {"debug.lines": tbuf.arrays("cpu")}, "jax": {"debug.lines": jbuf.arrays()}}
    ours, ref = run_pass(inputs, jdraw.DebugDrawPass(jbuf), tdraw.DebugDrawPass(tbuf), extra)
    np.testing.assert_array_equal(ours, ref)
    changed = np.abs(ours - inputs["torch"][1]["LDR"].numpy()).max(-1) > 0
    assert changed.mean() > 0.1


def test_debug_draw_crossing_lines_keep_the_later_colour(inputs):
    """The axes meet at the origin's pixel: there the z axis, the last
    line drawn, wins in both packages; and the buffer's capacity drops
    lines past it."""
    tbuf, jbuf = tdraw.DebugLineBuffer(), jdraw.DebugLineBuffer()
    for buf in (tbuf, jbuf):
        buf.axes(size=1.0)
    depth = {"torch": {"SceneDepth": torch.zeros((H, W)), "debug.lines": tbuf.arrays("cpu")},
             "jax": {"SceneDepth": jnp.zeros((H, W)), "debug.lines": jbuf.arrays()}}
    ours, ref = run_pass(inputs, jdraw.DebugDrawPass(jbuf), tdraw.DebugDrawPass(tbuf), depth)
    np.testing.assert_array_equal(ours, ref)
    cam = inputs["torch"][0].camera
    clip = cam.view_proj.numpy() @ np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    x = int((clip[0] / clip[3] * 0.5 + 0.5) * W)
    y = int((0.5 - clip[1] / clip[3] * 0.5) * H)
    np.testing.assert_allclose(ours[y, x], [0.2, 0.4, 1.0])
    small = tdraw.DebugLineBuffer(capacity=2)
    small.axes()
    assert small.count == 2


def test_scatter_last_is_the_in_order_scatter():
    """``scatter_last`` against the reference's scatter on random updates
    with many collisions (and updates that are off), through XLA."""
    rng = np.random.default_rng(7)
    ldr = rng.uniform(size=(6, 5, 3)).astype(np.float32)
    idx = rng.integers(0, 30, 400)
    on = rng.uniform(size=400) < 0.7
    cols = rng.uniform(size=(400, 3)).astype(np.float32)
    ours = scatter_last(torch.from_numpy(ldr), torch.from_numpy(idx), torch.from_numpy(on),
                        torch.from_numpy(cols)).numpy()
    flat = jnp.concatenate([jnp.asarray(ldr).reshape(-1, 3), jnp.zeros((1, 3))])
    ref = flat.at[jnp.where(jnp.asarray(on), jnp.asarray(idx), 30)].set(
        jnp.asarray(cols), mode="drop")[:-1].reshape(6, 5, 3)
    np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("xray", [False, True])
def test_light_icons_match_jax(inputs, xray):
    """The five lights' bulbs (two overlap; one is black), depth-tested
    unless xray: equal."""
    ours, ref = run_pass(inputs, jicons.IconBillboardPass(xray=xray),
                         ticons.IconBillboardPass(xray=xray))
    np.testing.assert_array_equal(ours, ref)
    assert (np.abs(ours - inputs["torch"][1]["LDR"].numpy()).max(-1) > 0).sum() > 20


def test_ddgi_probe_debug_matches_jax(inputs):
    """The probes' discs coloured by their mean irradiance: within 1e-6,
    the same pixels covered."""
    jgrid = inputs["grid"]
    tgrid = bridge.probe_grid_from(jgrid)
    assert isinstance(tgrid, TGrid)
    ours, ref = run_pass(inputs, jdd.DDGIProbeDebugPass(jgrid), tdd.DDGIProbeDebugPass(tgrid))
    ldr = inputs["torch"][1]["LDR"].numpy()
    np.testing.assert_array_equal(ours != ldr, ref != ldr)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert (np.abs(ours - ldr).max(-1) > 0).sum() > 20


APP_FLAGS = {"--debug-draw": ["--debug-draw"], "--light-icons": ["--light-icons"],
             "--ddgi-probe-debug": ["--ddgi", "--ddgi-probe-debug"]}
APP_PASS = {"--debug-draw": "DebugDraw", "--light-icons": "IconBillboards",
            "--ddgi-probe-debug": "DDGIProbeDebug"}


@pytest.mark.parametrize("flag", sorted(APP_FLAGS))
def test_app_overlay_flags_match_the_jax_app(flag, tmp_path, monkeypatch):
    """The showcase app with each overlay flag at 64^2, 2 frames, against
    the JAX app's PNG; the overlay is the Renderer's last pass, as the
    reference's, and --debug-draw's axes and box are in the buffer."""
    from arkoserenderer_torch.apps import showcase
    from arkoserenderer_torch.utils.imageio import load_png
    from arkoserenderer_tpu.apps.showcase import main as jax_main

    monkeypatch.setenv("ARKTPU_COMPILE_CACHE", "0")
    argv = ["--width", "64", "--height", "64", "--frames", "2"] + APP_FLAGS[flag]
    r = showcase.main(argv + ["--out", str(tmp_path / "ours.png")], device="cpu")
    jax_main(argv + ["--out", str(tmp_path / "ref.png")])
    ours, ref = load_png(str(tmp_path / "ours.png")), load_png(str(tmp_path / "ref.png"))[..., :3]
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 1.5 and (diff > 24).mean() < 0.005, (diff.mean(), (diff > 24).mean())
    assert [p.name for p in r.pipeline.passes][-1] == APP_PASS[flag]
    if flag == "--debug-draw":
        assert r.debug.count == 3 + 12
        plain = showcase.main(["--width", "64", "--height", "64", "--frames", "2", "--out",
                               str(tmp_path / "plain.png")], device="cpu")
        assert not torch.equal(plain.state["LDR"], r.state["LDR"])


def test_renderer_debug_draw_uploads_the_buffer_each_frame():
    """``Renderer(debug_draw=True)`` makes ``debug``; a line added between
    frames shows in the next frame, and a cleared buffer draws nothing."""
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import Renderer

    scene, cam = t_build_test_scene(viewport=(32, 16))
    cfg = TPipelineConfig(width=32, height=16, shadow_map_size=32,
                          raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64))
    r = Renderer(scene, cam, cfg, device="cpu", taa=False, bloom=False, debug_draw=True)
    plain = Renderer(scene, cam, cfg, device="cpu", taa=False, bloom=False)
    assert [p.name for p in r.pipeline.passes][-1] == "DebugDraw"
    assert torch.equal(r.render_frame(), plain.render_frame())
    r.debug.line((-20.0, 0.01, 0.0), (20.0, 0.01, 0.0), (1.0, 0.0, 1.0))
    drawn = r.render_frame()
    assert ((drawn - plain.render_frame()).abs().max(-1).values > 0).sum() >= 8
    r.debug.clear()
    assert torch.equal(r.render_frame(), plain.render_frame())
