"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of configurations, traffic mixes, scenes and metrics by name."""

import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest

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


def test_new_files_alone_add_a_cell(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with new entries in a copy of BENCHMARK.json, run through the
    harness with no file of it edited."""
    bench = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench,
                    ignore=shutil.ignore_patterns("reference", "tests", "__pycache__"))
    config = json.loads((bench / "configs" / "stress.json").read_text())
    config["renderer"] = {"taa": True, "bloom": False}
    config["compare"] = ["Visibility", "LDR"]
    config["limits"] = {"start.LDR.mean": 1e-3, "step.LDR.mean": 1e-3, "step.Visibility": 1e-3}
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

    result, _ = run_cell("dummy.still", 5, 0.2, True, time.perf_counter(), device="cpu",
                         small=True, spec=spec)
    assert result["correct"] is True
    assert result["metrics"]["dummy.frames_traced"]["value"] >= 4
    assert list(result)[-1] == "checks"
