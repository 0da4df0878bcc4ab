"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell ``<config>.<traffic>`` names a configuration and a traffic mix; a
per-layer metric ``<family>[.<part>]`` names its reader. Everything is found
under ``bench_dir`` (``perfbench/``), so a configuration, a mix or a metric
joins the benchmark as new files and new entries in ``BENCHMARK.json``, with
no file here edited. The files, and what each defines:

  configs/<c>.json     the configuration as it is run (``BENCHMARK.json``'s
                       ``file``): ``width``, ``height``, ``shadow_map_size``,
                       ``raster`` (``RasterConfig``'s fields); ``scene``:
                       ``{"builder": <b>, ...}`` (the rest goes to the
                       builder); ``reference``: <r>; ``compare``: the
                       program's resources compared; ``limits``:
                       ``{<number>: <limit>}``, the numbers of
                       ``lib/check.py`` that decide ``correct``; optional
                       ``renderer``: ``Renderer``'s keyword flags (``taa``,
                       ``rt_shadows``, ...), where ``"ddgi"`` is ``true``
                       (the program's own fit) or ``{"dims": [x, y, z],
                       "rays_per_probe": n, "probes_per_frame": n}``
                       (``ProbeGridConfig.fit_bounds``'s keywords: the
                       grid fitted to the scene's bounds); optional ``pipeline``: any
                       ``PipelineConfig`` field but those four and ``scene``
                       (``rt_scale``, ``texture_quality``,
                       ``local_shadow_map_size``, ...), laid over the
                       defaults; optional ``test_size``: keys that replace
                       these whole for the CPU tests
  scenes/<b>.py        ``build(prog, params, viewport, traffic) -> (scene,
                       camera, renderer keywords)`` through the program's
                       entry points (``lib/pkg.py``; ``prog.module(path)``
                       reaches any other module of the program), and
                       ``animation(scene, traffic)``: what the reference
                       needs of an animation the builder set (None: none)
  reference/<r>.py     ``Frame(inputs, config, device)`` with ``render(frame,
                       state) -> (resources, state)``: the plain reference,
                       handed the authored scene (``lib/inputs.py``) and
                       the camera path; ``state`` maps the program's
                       persistent resource names to tensors (empty before
                       frame 0; at ``step`` the program's copy of every
                       floating-point entry) and it returns the whole state
                       it carries into the next frame: every entry it read
                       (else ``lib/check.py`` refuses it), each of which is
                       compared as ``state.<name>``.
                       It imports nothing of the program; another
                       reference's pieces it imports relatively (``from
                       .forward import raster``)
  traffic/<m>.json     the parameters of ``lib/traffic.Traffic``
  metrics/<n>.py       ``read(ctx, part)``: the per-layer metric ``n``, or a
                       family's (``metrics/<family>.py``, told the part), or
                       None where the run has nothing to read
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json
BENCH = Path(__file__).resolve().parents[1]  # perfbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REFERENCES = "perfbench_reference"  # the package the reference files load as


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

    def reference(self, name: str):
        """``reference/<name>.py`` under ``bench_dir``, imported as
        ``perfbench_reference.<name>``: the reference files form one package,
        made anew for each call, so that a reference imports another's
        pieces relatively and always from this ``bench_dir``."""
        for k in [k for k in sys.modules if k == REFERENCES or k.startswith(REFERENCES + ".")]:
            del sys.modules[k]
        pkg = types.ModuleType(REFERENCES)
        pkg.__path__ = [str(self.bench_dir / "reference")]
        sys.modules[REFERENCES] = pkg
        return importlib.import_module(f"{REFERENCES}.{name}")

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
