"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of configurations, traffic mixes, scenes and metrics by name."""

import json
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib.spec import NAME, UNIT, Spec  # noqa: E402

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)
    assert 1 <= len(DATA["paths"]) <= 16 and all(PATH.match(p) for p in DATA["paths"])
    assert all(not p.endswith("_torch") and (ROOT / p).is_dir() for p in DATA["paths"])
    assert 1 <= len(DATA["command"]) <= 32 and all(LINE.match(w) for w in DATA["command"])
    assert not any(w.startswith("/") or ".." in w for w in DATA["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_allowed_characters(section):
    names = [e["name"] for e in DATA[section]]
    assert len(names) == len(set(names))
    for e in DATA[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_entries_have_only_the_contract_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in DATA["end_to_end"])
    e2e = {m["name"] for m in DATA["end_to_end"]}
    layers: dict = {}
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])


def test_every_cell_resolves_to_its_files():
    spec = Spec()
    for w in DATA["workloads"]:
        cell = spec.cell(w["name"])
        config = spec.config(cell["config"])
        assert spec.scene_builder(config["scene"]["builder"]).build
        assert "camera" in spec.traffic(cell["traffic"])
        assert config["limits"], "a configuration names the numbers it compares"
        assert spec.end_to_end(w["name"]) and spec.per_layer(w["name"])
        for m in spec.per_layer(w["name"]):
            reader, _ = spec.metric_reader(m["name"])
            assert callable(reader.read)
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("perfbench/") for f in files)


RT_CONFIG = {
    "source": "a test", "scene": {"builder": "rt_test_scene"},
    "width": 48, "height": 32, "shadow_map_size": 128,
    "raster": {"tile_h": 8, "tile_w": 16, "max_tris_per_tile": 256, "max_tiles_per_tri": 16,
               "max_global_tris": 256},
    "renderer": {"taa": True, "rt_shadows": True, "rt_reflections": True,
                 "ddgi": {"dims": [4, 2, 4], "rays_per_probe": 16, "probes_per_frame": 8}},
    "pipeline": {"texture_quality": "bilinear", "local_shadow_map_size": 64},
    "compare": ["LDR"], "limits": {"step.LDR.mean": 1e-3}, "reference": "recorder",
}
SPOT = {"position": [1.0, 4.0, 2.0], "direction": [-0.2, -1.0, -0.4],
        "luminous_intensity_cd": 9000.0, "inner_cone_angle": 0.3, "outer_cone_angle": 0.5,
        "source_radius": 0.2}
RT_SCENE = f"""
import numpy as np

SPOT = {SPOT!r}


def build(prog, params, viewport, traffic):
    scene, camera = prog.procedural.build_test_scene(viewport=viewport)
    lights, sc = prog.module("scene.lights"), prog.module("scene.scene")
    scene.spots.append(lights.SpotLight(
        **{{k: np.array(v, np.float32) if isinstance(v, list) else v for k, v in SPOT.items()}},
        cast_shadows=True))
    mr = np.zeros((8, 8, 4), np.uint8)
    mr[..., 1], mr[..., 2], mr[..., 3] = 128, 255, 255
    tex = scene.add_texture(mr, srgb=False)
    mat = scene.add_material(sc.Material(mr_tex=tex, metallic_factor=0.9, roughness_factor=0.4))
    ball = prog.procedural.make_uv_sphere(0.5, rings=8, sectors=12)
    ball.material = mat
    world = np.eye(4, dtype=np.float32)
    world[:3, 3] = (1.0, 0.5, 1.5)
    scene.add_instance(scene.add_segment(ball), world)
    return scene, camera, {{}}


def animation(scene, traffic):
    return None
"""
RECORDER = """
from pathlib import Path

import torch

from . import forward

HANDED = Path(__file__).with_name("handed.pt")


class Frame:
    def __init__(self, inputs, config, device):
        self.record = {"spots": inputs["spots"], "materials": inputs["materials"],
                       "srgb": [im["srgb"] for im in inputs["images"]], "calls": [],
                       "forward": forward.__file__}

    def render(self, frame, state):
        self.record["calls"].append((frame, {k: v.cpu().clone() for k, v in state.items()}))
        torch.save(self.record, HANDED)
        return {}, dict(state)
"""


def files_before(bench: Path) -> dict:
    return {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}


@pytest.mark.parametrize("kind", ["forward", "ray_traced"])
def test_new_files_alone_add_a_cell(tmp_path, kind):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with new entries in a copy of BENCHMARK.json, run through the
    harness with no file of it edited. ``forward``: a configuration that
    reuses ``reference/forward.py``. ``ray_traced``: the test scene with a
    shadow-casting spot and a metal-roughness texture, RT shadows and
    reflections, a DDGI grid and ``pipeline`` settings, its scene builder
    and a stub reference (``reference/recorder.py``, importing the copy's
    ``forward.py`` relatively) that records what it was handed: the spot's and the material's fields, and at ``step`` the
    program's every floating-point persistent entry, equal to the program's
    state before that frame; the ``pipeline`` settings reach the
    renderer."""
    bench = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = files_before(bench)
    if kind == "forward":
        config = json.loads((bench / "configs" / "stress.json").read_text())
        config["renderer"] = {"taa": True, "bloom": False}
        config["compare"] = ["Visibility", "LDR"]
        config["limits"] = {"start.LDR.mean": 1e-3, "step.LDR.mean": 1e-3,
                            "step.Visibility": 1e-3}
    else:
        config = RT_CONFIG
        (bench / "scenes" / "rt_test_scene.py").write_text(RT_SCENE)
        (bench / "reference" / "recorder.py").write_text(RECORDER)
    (bench / "configs" / "dummy.json").write_text(json.dumps(config))
    (bench / "traffic" / "still.json").write_text(json.dumps({"camera": {"kind": "static"}}))
    (bench / "metrics" / "dummy.frames_traced.py").write_text(
        "def read(ctx, part):\n    return float(ctx.frames_traced)\n")
    data = json.loads(json.dumps(DATA))
    data["configs"].append({"name": "dummy", "source": "a test", "reduced": [],
                            "file": "perfbench/configs/dummy.json", "why": "a test"})
    data["workloads"].append({"name": "dummy.still", "config": "dummy", "traffic": "still",
                              "chips": 1, "why": "a test"})
    data["per_layer"].append({"name": "dummy.frames_traced", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "a test", "moves": "frame_ms",
                              "workloads": ["dummy.still"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path / "BENCHMARK.json", bench)
    from perfbench.lib.harness import run_cell

    seen, handed = [], []

    def watch(renderer):
        """Keep the renderer, and a copy of the persistent state each frame
        starts from."""
        seen.append(renderer)
        inner = renderer.pipeline.render_frame

        def render(state, *args, **kw):
            handed.append({k: v.clone() for k, v in state.items()
                           if k in renderer.pipeline.registry.persistent_names
                           and isinstance(v, torch.Tensor) and v.is_floating_point()})
            return inner(state, *args, **kw)

        renderer.pipeline.render_frame = render

    result, _ = run_cell("dummy.still", 5, 0.2, kind == "forward", time.perf_counter(),
                         device="cpu", small=True, spec=spec, break_program=watch)
    assert list(result)[-1] == "checks"
    assert all(before[p] == p.read_bytes() for p in before)
    if kind == "forward":
        assert result["correct"] is True
        assert result["metrics"]["dummy.frames_traced"]["value"] >= 4
        return

    rec = torch.load(bench / "reference" / "handed.pt", weights_only=False)
    assert Path(rec["forward"]) == bench / "reference" / "forward.py"
    spot = rec["spots"][0]
    for k, v in SPOT.items():
        assert np.allclose(spot[k], v), k
    assert spot["cast_shadows"] is True
    (mat,) = [m for m in rec["materials"] if m["mr_tex"] != 0]
    assert rec["srgb"][mat["mr_tex"]] is False
    assert (mat["metallic_factor"], mat["roughness_factor"]) == pytest.approx((0.9, 0.4))
    assert [f for f, _ in rec["calls"]] == [0, 1, 2, seen[0].frame_index - 1]
    assert rec["calls"][0][1] == {}
    step = rec["calls"][-1][1]
    program = handed[-1]
    assert {"TAAHistory", "DDGI.irradiance", "DDGI.visibility", "RTRefl.history"} <= set(step)
    assert set(step) == set(program)
    assert all(torch.equal(step[k], program[k]) for k in step)
    cfg = seen[0].cfg
    assert (cfg.texture_quality, cfg.local_shadow_map_size) == ("bilinear", 64)
    grid = seen[0]._pipeline_kw["ddgi"]
    assert (grid.dims, grid.rays_per_probe, grid.probes_per_frame) == ((4, 2, 4), 16, 8)


class Reads:
    """A reference's frame that reads the state entry ``DDGI.irradiance``
    (by ``how``) and returns the entries ``keeps``."""

    def __init__(self, how: str, keeps: tuple):
        self.how, self.keeps = how, keeps

    def render(self, frame, state):
        if self.how == "get":
            state.get("DDGI.irradiance")
        elif self.how == "item":
            state["DDGI.irradiance"]
        else:
            {**state}
        return {}, {k: state[k] for k in self.keeps if k in state}


@pytest.mark.parametrize("how", ["get", "item", "copy"])
def test_a_reference_returns_the_state_it_reads(how):
    """``render`` returns the whole state it carries into the next frame: a
    reference that reads a handed entry and drops it is refused, so no
    entry it builds on goes uncompared."""
    from perfbench.lib import check

    state = {"TAAHistory": torch.zeros(2, 2, 3), "DDGI.irradiance": torch.ones(4, 3)}
    keeps = ("TAAHistory", "DDGI.irradiance")
    out, kept = check.render(Reads(how, keeps), 7, state)
    assert set(kept) == set(keeps)
    with pytest.raises(ValueError, match="DDGI.irradiance"):
        check.render(Reads(how, ("TAAHistory",)), 7, state)


@pytest.mark.parametrize("field", ["width", "raster", "scene"])
def test_pipeline_refuses_what_it_does_not_set(field):
    """A configuration's ``pipeline`` may not set what the harness sets from
    its top keys, nor ``scene``, which the renderer sets and would drop."""
    from perfbench.lib.harness import PROGRAM, package, pipeline_config

    prog = package(PROGRAM)
    config = {"shadow_map_size": 128, "raster": {}, "pipeline": {"rt_scale": 2}}
    assert pipeline_config(prog, config, (48, 32)).rt_scale == 2
    with pytest.raises(ValueError, match=field):
        pipeline_config(prog, {**config, "pipeline": {field: None}}, (48, 32))


@pytest.mark.parametrize("feature", ["none", "spot", "mr_texture"])
def test_forward_refuses_what_it_cannot_render(feature):
    """``reference/forward.py`` renders a sun, opaque base-coloured
    materials and no local light: a scene with a spot, or with a
    metal-roughness texture, is refused when its ``Frame`` is made."""
    from perfbench.lib.harness import PROGRAM, package
    from perfbench.lib.inputs import scene_inputs

    prog = package(PROGRAM)
    scene, camera = prog.procedural.build_test_scene(viewport=(48, 32))
    if feature == "spot":
        scene.spots.append(prog.module("scene.lights").SpotLight(
            position=np.array([0.0, 4.0, 0.0], np.float32),
            direction=np.array([0.0, -1.0, 0.0], np.float32)))
    elif feature == "mr_texture":
        tex = scene.add_texture(np.full((4, 4, 4), 200, np.uint8), srgb=False)
        scene.materials[1].mr_tex = tex
    inputs = scene_inputs(scene, camera)
    inputs["animation"] = None
    inputs["camera_path"] = lambda k: np.array(camera.position, np.float32)
    config = {**json.loads((ROOT / "perfbench" / "configs" / "stress.json").read_text())}
    config.update(config["test_size"])
    forward = Spec().reference("forward")
    if feature == "none":
        forward.Frame(inputs, config, "cpu")
    else:
        with pytest.raises(ValueError):
            forward.Frame(inputs, config, "cpu")
