"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell ``<config>.<traffic>`` names a configuration, whose file holds its
sizes and flags and names a scene builder (``scenes/<builder>.py``), and a
traffic mix (``traffic/<mix>.json``, parameters of ``lib/traffic``). A
per-layer metric ``<family>[.<part>]`` is read by ``metrics/<name>.py`` where
that file exists, else by ``metrics/<family>.py``, which is told the part.
Adding a configuration, a mix or a metric adds files and entries only."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json
BENCH = Path(__file__).resolve().parents[1]  # perfbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    def __init__(self, path: Path | None = None, bench_dir: Path | None = None):
        self.path = Path(path or ROOT / "BENCHMARK.json")
        self.bench_dir = Path(bench_dir or BENCH)
        self.data = json.loads(self.path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path.name}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.path.parent / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in {self.path.name}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def scene_builder(self, name: str):
        return load_module(self.bench_dir / "scenes" / f"{name}.py", f"perfbench_scene_{name}")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if cell in m.get("workloads", [cell])]

    def metric_reader(self, name: str):
        """(module, part): ``metrics/<name>.py`` with part None, else
        ``metrics/<family>.py`` with the rest of the name as the part."""
        whole = self.bench_dir / "metrics" / f"{name}.py"
        if whole.exists():
            return load_module(whole, "perfbench_metric_" + name.replace(".", "_")), None
        family, _, part = name.partition(".")
        path = self.bench_dir / "metrics" / f"{family}.py"
        if not part or not path.exists():
            raise FileNotFoundError(f"no reader for metric {name!r} under metrics/")
        return load_module(path, f"perfbench_metric_{family}"), part
