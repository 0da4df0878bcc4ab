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
* Each flag the port lacks raises NotImplementedError naming it before any
  scene is built.
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
def test_unported_flags_raise_by_name(flag, monkeypatch, tmp_path):
    import arkoserenderer_torch.assets.procedural as proc

    def no_scene(*a, **kw):
        raise AssertionError("a scene was built")

    monkeypatch.setattr(proc, "build_test_scene", no_scene)
    with pytest.raises(NotImplementedError, match=flag):
        showcase.main(["--out", str(tmp_path / "x.png")] + UNPORTED[flag], device="cpu")
    assert not (tmp_path / "x.png").exists()


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
