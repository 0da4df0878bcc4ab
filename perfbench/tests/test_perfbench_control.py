"""The control: the plain reference put in the program's place with its
float32 matrix products in TF32, the nearest precision below the
configuration's float32 with TF32 off, comes out not correct through the
harness's own verdict at the cell's own size, on each seed. TF32 exists on
the card only, so this runs there::

    python -m pytest perfbench/tests/test_perfbench_control.py -p no:cacheprovider -o addopts="" -s

Each case prints one JSON line: the control's numbers (the upper readings
the limits are set from) and the program's (lower readings), each beside
the configuration's limits. The cells are ``BENCHMARK.json``'s
``workloads``."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib.harness import run_cell  # noqa: E402

SEEDS = [2**31 + 1, 2**32 + 5, 91, 7_000_003]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists on the card only")
    result, log = run_cell(cell, seed, 2.0, False, time.perf_counter(), control=True)
    print(json.dumps({"cell": cell, "seed": seed, "control": log["control"],
                      "program": log["numbers"], "frames": log["frames"],
                      "reference_s": log["reference_s"]}), flush=True)
    assert result["correct"] is False, log["checks"]
