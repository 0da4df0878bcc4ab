"""The port's showcase app (``arkoserenderer_torch/apps/showcase.py``) on the
CPU, against the JAX package's app.

* The same argv through both apps at 64^2, 2 frames: the default flags,
  ``--texture-quality stochastic1 --ssao --dof``, and the .arklvl level
  (with ``--oit-layers 2`` and without) and the JSON .arkmsh of
  ``tools/ark_level.write_level``, whose translucent sphere runs
  ForwardTranslucent. The port's PNG is held to
  the JAX app's under the golden thresholds (tests/test_golden.py: mean abs
  diff < 1.5, under 0.5 % of pixels off by more than 24). The JAX app runs
  with its persistent compile cache off (ARKTPU_COMPILE_CACHE=0), so this
  worker's later JAX compiles are not changed by it.
* The port's other supported flags run and write a finite image: the
  helmet glTF (``--gltf``, textures at 256), ``--pathtracer --samples``,
  ``--upscale 1.5 --upscale-mode spatial`` with soft ray-traced shadows
  (``--rt-shadows --sun-angular-radius``), and ``--timings``, which refuses
  the CPU (it times the card).
* The overlay flags (``--debug-draw``, ``--light-icons``,
  ``--ddgi-probe-debug``), ported since, build the reference's passes (their
  frames against the JAX app's: test_torch_debug_passes.py).
* The meshviewer app (``apps/meshviewer.py``) on a synthetic glTF against
  the JAX app: ``describe``, ``--inspect-segment``, ``--meshlets``,
  ``--set-material ... --save`` and the saved file's round trip, and the
  ``--view normal`` turntable (PNGs under the goldens' bound);
  ``--interactive``'s orbit view served over HTTP (frames and stats).
* The geodata app (``apps/geodata.py``): the region crop, the terrain's
  arrays (both LOD levels, the texture, the scene's pools) equal to JAX's,
  and a 64^2 frame against the JAX app's under the goldens' bound.
* ``utils/imageio.save_png``'s bytes read back by PIL exactly (PIL is the
  tests' reference only), and ``load_image_rgba`` as PIL converts them.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from arkoserenderer_torch.apps import showcase
from arkoserenderer_torch.utils.imageio import encode_png, load_image_rgba, load_png, save_png

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HELMET = ROOT / "assets" / "sample" / "DamagedHelmet" / "DamagedHelmet.gltf"
SIZE = ["--width", "64", "--height", "64", "--frames", "2"]
# "{level}" and "{mesh}" stand for the .arklvl and the JSON .arkmsh (a
# translucent sphere) of tools/ark_level.write_level, written per test.
PARITY_ARGV = {"default": [], "stochastic1": ["--texture-quality", "stochastic1", "--ssao",
                                              "--dof"],
               "oit_layers": ["--gltf", "{level}", "--oit-layers", "2"],
               "arklvl": ["--gltf", "{level}"], "arkmsh": ["--gltf", "{mesh}"]}
UNPORTED = {"--debug-draw": ["--debug-draw"], "--light-icons": ["--light-icons"],
            "--ddgi-probe-debug": ["--ddgi", "--ddgi-probe-debug"]}
OVERLAY_PASS = {"--debug-draw": "DebugDraw", "--light-icons": "IconBillboards",
                "--ddgi-probe-debug": "DDGIProbeDebug"}


def assert_golden_close(ours, ref):
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 1.5, f"mean abs diff {diff.mean():.3f}"
    assert (diff > 24).mean() < 0.005, f"{(diff > 24).mean():.2%} pixels off by > 24"


@pytest.mark.parametrize("case", sorted(PARITY_ARGV))
def test_app_matches_the_jax_app(case, tmp_path, monkeypatch):
    from arkoserenderer_tpu.apps.showcase import main as jax_main

    from arkoserenderer_torch.tools.ark_level import write_level

    monkeypatch.setenv("ARKTPU_COMPILE_CACHE", "0")
    argv = SIZE + PARITY_ARGV[case]
    if any("{" in a for a in argv):
        paths = write_level(tmp_path / "tree")
        argv = [a.format(level=paths["level"], mesh=paths["sphere"]) for a in argv]
    ours_png, ref_png = tmp_path / "ours.png", tmp_path / "ref.png"
    r = showcase.main(argv + ["--out", str(ours_png)], device="cpu")
    jax_main(argv + ["--out", str(ref_png)])
    ours, ref = load_png(str(ours_png)), load_png(str(ref_png))[..., :3]
    assert ours.shape == (64, 64, 3) and ours.std() > 5
    assert_golden_close(ours, ref)
    assert r.frame_index == 3 and r.cfg.texture_quality == (
        "stochastic1" if case == "stochastic1" else "trilinear")
    assert r.cfg.raster.tile_w == 16 and r.cfg.shadow_map_size == 1024
    names = [p.name for p in r.pipeline.passes]
    if case in ("oit_layers", "arklvl", "arkmsh"):
        layers = r.pipeline.passes[names.index("ForwardTranslucent")].layers
        assert layers == (2 if case == "oit_layers" else 1)
        assert len(r.scene.instances) == (6 if case != "arkmsh" else 1)


@pytest.mark.parametrize("case", ["gltf", "pathtracer", "upscale"])
def test_app_runs_its_supported_flags(case, tmp_path):
    out = tmp_path / "frame.png"
    argv = {"gltf": ["--width", "32", "--height", "32", "--frames", "1", "--gltf", str(HELMET)],
            "pathtracer": ["--width", "32", "--height", "32", "--pathtracer", "--samples", "2"],
            "upscale": ["--width", "32", "--height", "32", "--frames", "1", "--upscale", "1.5",
                        "--upscale-mode", "spatial", "--rt-shadows",
                        "--sun-angular-radius", "2"]}[case]
    result = showcase.main(argv + ["--out", str(out)], device="cpu")
    img = load_png(str(out))
    assert img.shape == ((48, 48, 3) if case == "upscale" else (32, 32, 3)) and img.std() > 2
    if case == "pathtracer":
        assert result.sample_count == 2
    elif case == "gltf":
        assert len(result.scene.materials) > 1 and result.scene.sun is not None
    else:
        assert result.scene.sun.angular_radius_deg == 2.0
        assert [p.name for p in result.pipeline.passes][-1] == "Upscale"


def test_timings_refuse_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="card"):
        showcase.main(["--width", "32", "--height", "32", "--frames", "1", "--timings",
                       "--out", str(tmp_path / "t.png")], device="cpu")


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_unported_flags_raise_by_name(flag):
    """Each overlay flag, ported since, builds the pipeline the JAX app's
    Renderer builds for the same flags, the overlay last (no frame is
    rendered here)."""
    from arkoserenderer_tpu.apps import showcase as jshowcase
    from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

    argv = ["--width", "32", "--height", "32"] + UNPORTED[flag]
    args = showcase.build_arg_parser().parse_args(argv)
    r = showcase.make_renderer(args, *showcase.build_scene(args), device="cpu")
    jargs = jshowcase.build_arg_parser().parse_args(argv)
    jscene, jcam = jshowcase.build_scene(jargs)
    jr = JRenderer(jscene, jcam, JPipelineConfig(
        width=32, height=32, raster=JRasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
        shadow_map_size=1024), ddgi=True if jargs.ddgi else None,
        ddgi_probe_debug=jargs.ddgi_probe_debug, debug_draw=jargs.debug_draw,
        light_icons=jargs.light_icons)
    names = [p.name for p in r.pipeline.passes]
    assert names == [p.name for p in jr.pipeline.passes] and names[-1] == OVERLAY_PASS[flag]
    assert (r.debug is not None) == (flag == "--debug-draw")


@pytest.mark.parametrize("channels", [1, 2, 3, 4, "float"])
def test_save_png_reads_back_in_pil(channels, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    if channels == "float":
        img = rng.uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32)
        want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (9, 13, channels)).astype(np.uint8)
        want = img
    path = tmp_path / "x.png"
    save_png(str(path), img)
    assert path.read_bytes() == encode_png(img)
    with Image.open(path) as im:
        got = np.asarray(im)
        rgba = np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(load_image_rgba(str(path)), rgba)
    with Image.open(io.BytesIO(encode_png(img))) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(want.shape), want)


# -- meshviewer ---------------------------------------------------------------------


def _both_meshviewers(argv, capsys):
    """(port's result, its stdout, JAX app's stdout) of one argv."""
    from arkoserenderer_tpu.apps import meshviewer as jviewer

    from arkoserenderer_torch.apps import meshviewer

    ours = meshviewer.main(argv, device="cpu")
    out = capsys.readouterr().out
    jviewer.main(argv)
    return ours, out, capsys.readouterr().out


def test_meshviewer_describes_like_the_jax_app(tmp_path, capsys):
    """``describe``, ``--inspect-segment`` and ``--meshlets`` on a synthetic
    glTF (two meshes, textured materials): the JAX app's text."""
    from test_torch_gltf import material_gltf

    src = str(material_gltf(tmp_path))
    scene, ours, ref = _both_meshviewers([src, "--no-render", "--inspect-segment", "1",
                                          "--meshlets"], capsys)
    assert ours == ref
    assert "segments: 2" in ours and "segment [1]" in ours and "meshlets:" in ours
    assert "instance 1: lod band [0.0, inf)" in ours and len(scene.materials) == 3


def test_meshviewer_edit_save_round_trip(tmp_path, capsys):
    """``--set-material`` (a float, an int and a vector field) with
    ``--save``: the same text as the JAX app, and each app's saved file
    loads in both packages with the edits."""
    from arkoserenderer_tpu.assets.baked import load_baked as j_load_baked

    from arkoserenderer_torch.assets.baked import load_baked, save_baked
    from arkoserenderer_torch.assets.procedural import build_test_scene

    scene, _ = build_test_scene(viewport=(64, 64))
    src = str(tmp_path / "scene.npz")
    save_baked(scene, src)
    edits = ["--set-material", "1", "roughness_factor=0.25", "blend_mode=1",
             "base_color_factor=0.1,0.2,0.3,1"]
    argv = [src, "--no-render", "--inspect-segment", "0"] + edits
    _, ours, ref = _both_meshviewers(argv + ["--save", str(tmp_path / "t.npz")], capsys)
    assert ours.replace("t.npz", "x") == ref.replace("t.npz", "x")
    from arkoserenderer_tpu.apps import meshviewer as jviewer

    jviewer.main(argv + ["--save", str(tmp_path / "j.npz")])
    for path in ("t.npz", "j.npz"):
        for load in (load_baked, j_load_baked):
            m = load(str(tmp_path / path), limits=scene.limits).materials[1]
            assert abs(m.roughness_factor - 0.25) < 1e-6 and m.blend_mode == 1
            np.testing.assert_allclose(m.base_color_factor, [0.1, 0.2, 0.3, 1.0], atol=1e-6)
    with pytest.raises(ValueError, match="no field"):
        from arkoserenderer_torch.apps import meshviewer

        meshviewer.main([src, "--no-render", "--set-material", "1", "shininess=3"],
                        device="cpu")


def test_meshviewer_view_normal_matches_the_jax_app(tmp_path, capsys):
    """The ``--view normal`` turntable (2 frames at 64^2) on a baked test
    scene: each PNG within the goldens' bound of the JAX app's, and the
    DebugVisualize pass last."""
    from arkoserenderer_torch.assets.baked import save_baked
    from arkoserenderer_torch.assets.procedural import build_test_scene

    scene, _ = build_test_scene(viewport=(64, 64))
    src = str(tmp_path / "scene.npz")
    save_baked(scene, src)
    argv = [src, "--frames", "2", "--size", "64", "--view", "normal"]
    from arkoserenderer_tpu.apps import meshviewer as jviewer

    from arkoserenderer_torch.apps import meshviewer

    r = meshviewer.main(argv + ["--out", str(tmp_path / "t_{frame}.png")], device="cpu")
    jviewer.main(argv + ["--out", str(tmp_path / "j_{frame}.png")])
    assert [p.name for p in r.pipeline.passes][-1] == "DebugVisualize"
    for f in range(2):
        ours = load_png(str(tmp_path / f"t_{f}.png"))
        assert_golden_close(ours, load_png(str(tmp_path / f"j_{f}.png"))[..., :3])
        assert ours.std() > 5


def test_meshviewer_interactive_serves_orbit(tmp_path):
    """``--interactive``: the orbit view over HTTP (the reference's
    ``apps/meshviewer.py:207-233``) serves the frames as PNGs and the
    stats, and returns the Renderer after ``--frames`` frames."""
    import json
    import socket
    import threading
    import time
    import urllib.request

    from arkoserenderer_torch.apps import meshviewer
    from arkoserenderer_torch.assets.baked import save_baked
    from arkoserenderer_torch.assets.procedural import build_test_scene
    from arkoserenderer_torch.utils.imageio import decode_png

    scene, _ = build_test_scene(viewport=(64, 64), n_spheres=1)
    src = str(tmp_path / "scene.npz")
    save_baked(scene, src)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    result = {}

    def run():
        try:
            result["r"] = meshviewer.main([src, "--interactive", "--size", "64", "--frames", "4",
                                           "--port", str(port)], device="cpu")
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            result["error"] = repr(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    png = b""
    for _ in range(240):
        try:
            png = urllib.request.urlopen(base + "/frame.png", timeout=60).read()
            if png:
                break
        except OSError:
            pass
        assert "error" not in result, result
        time.sleep(0.25)
    img = decode_png(png)
    assert img.shape == (64, 64, 3) and img.std() > 5
    for _ in range(480):  # the stats are published just after the frame
        stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=60).read())
        if stats["ms"] > 0:
            break
        time.sleep(0.25)
    assert stats["frame"] >= 0 and stats["ms"] > 0
    assert b"viewer" in urllib.request.urlopen(base + "/", timeout=60).read()
    th.join(timeout=240)
    assert not th.is_alive() and "error" not in result, result
    r = result["r"]
    assert r.frame_index == 4 and r.cfg.width == 64


# -- geodata --------------------------------------------------------------------------


@pytest.mark.parametrize("region", [(0.2, 0.2, 0.6, 0.6), (0.0, 0.5, 1.0, 1.0),
                                    (0.9, 0.9, 0.9, 0.9)])
def test_geodata_region_crop_matches_jax(region):
    from arkoserenderer_tpu.apps import geodata as jgeo

    from arkoserenderer_torch.apps import geodata

    h = geodata.fbm_heightmap(65)
    np.testing.assert_array_equal(h, jgeo.fbm_heightmap(65))
    ours = geodata.crop_region(h, region)
    np.testing.assert_array_equal(ours, jgeo.crop_region(h, region))
    assert min(ours.shape) >= 2


def test_geodata_terrain_arrays_match_jax(tmp_path):
    """A heightmap image (``load_heightmap``) into both apps' terrain
    scenes: both LOD levels, the altitude texture and every pool of the
    build equal."""
    from arkoserenderer_tpu.apps import geodata as jgeo

    from arkoserenderer_torch import bridge
    from arkoserenderer_torch.apps import geodata
    from test_torch_scene import assert_field_equal

    dem = (geodata.fbm_heightmap(33) * 255).astype(np.uint8)
    save_png(str(tmp_path / "dem.png"), dem[..., None].repeat(3, -1))
    h = geodata.load_heightmap(str(tmp_path / "dem.png"))
    np.testing.assert_array_equal(h, jgeo.load_heightmap(str(tmp_path / "dem.png")))
    ts, tcam = geodata.build_terrain_scene(h, (64, 64))
    js, _ = jgeo.build_terrain_scene(h, (64, 64))
    assert [s.num_triangles for s in ts.segments] == [2 * 32 * 32, 2 * 8 * 8]
    assert [it[3] for it in ts.instances] == [(0.0, 36.0), (36.0, 3.4e38)]
    ours, ref = bridge.numpy_fields(ts.build("cpu")), bridge.numpy_fields(js.build())
    for name in sorted(ours):
        assert_field_equal(name, ours[name], ref[name])


def test_geodata_frame_matches_the_jax_app(tmp_path):
    """``--grid 65 --region ...`` at 64^2, 2 frames: the JAX app's PNG
    within the goldens' bound."""
    from arkoserenderer_tpu.apps.geodata import main as jax_main

    from arkoserenderer_torch.apps import geodata

    argv = ["--width", "64", "--height", "64", "--frames", "2", "--grid", "65",
            "--region", "0.0", "0.0", "0.75", "1.0", "--height-scale", "5"]
    r = geodata.main(argv + ["--out", str(tmp_path / "t.png")], device="cpu")
    jax_main(argv + ["--out", str(tmp_path / "j.png")])
    ours = load_png(str(tmp_path / "t.png"))
    assert_golden_close(ours, load_png(str(tmp_path / "j.png"))[..., :3])
    assert ours.std() > 5 and r.cfg.raster.max_tris_per_tile == 512
