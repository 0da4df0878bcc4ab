"""Nothing the benchmark loads is JAX or the JAX package, and the plain
references load nothing of the program: checked in fresh processes by the
top-level name of every module (the part before the first dot)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOAD_ALL = """
import json, runpy, sys
sys.path.insert(0, {root!r})
runpy.run_path({root!r} + "/perfbench/run.py", run_name="perfbench_run")
from perfbench.lib import harness
from perfbench.lib.spec import Spec
spec = Spec()
for w in spec.data["workloads"]:
    config = spec.config(w["config"])
    spec.scene_builder(config["scene"]["builder"])
    spec.reference(config["reference"])
    for m in spec.per_layer(w["name"]):
        spec.metric_reader(m["name"])
harness.package(harness.PROGRAM)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.lib.spec import Spec
for name in {names!r}:
    Spec().reference(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCES = sorted(p.stem for p in (ROOT / "perfbench" / "reference").glob("*.py"))


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    names = top_level(LOAD_ALL.format(root=str(ROOT)))
    assert "arkoserenderer_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "arkoserenderer_tpu"}


def test_reference_loads_nothing_of_the_program():
    assert REFERENCES
    names = top_level(LOAD_REFERENCE.format(root=str(ROOT), names=REFERENCES))
    assert "torch" in names
    assert not names & {"arkoserenderer_torch", "jax", "jaxlib", "flax", "arkoserenderer_tpu"}


def test_reference_sources_name_no_program_module():
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        for line in path.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "arkoserenderer" not in line, (path, line)
