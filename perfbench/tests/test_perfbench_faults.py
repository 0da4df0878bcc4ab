"""A run of each cell, with the look for a card skipped and the timed path
broken underneath, comes out not correct; the same run unbroken comes out
correct. The cells are ``BENCHMARK.json``'s ``workloads``, so a cell added
there gets its cases. Each fault a one-chip frame can have: a frame that returns its
persistent state unchanged, half the frame left out, and one pixel of the
frame altered where it is produced. (No cell spans chips, so there is no
exchange to leave out.) CPU, at the configurations' test sizes."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib.harness import run_cell  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def wrap(renderer, change):
    """Make the renderer's pipeline apply ``change(inputs, outputs)`` to
    every frame it renders."""
    inner = renderer.pipeline.render_frame

    def render(state, *args, **kw):
        out = inner(state, *args, **kw)
        change(state, out)
        return out

    renderer.pipeline.render_frame = render


def state_unchanged(renderer):
    names = renderer.pipeline.registry.persistent_names

    def change(state, out):
        out.update({n: state[n] for n in names if n in state})

    wrap(renderer, change)


def half_left_out(renderer):
    def change(state, out):
        h = out["LDR"].shape[0]
        out["LDR"] = out["LDR"].clone()
        out["LDR"][h // 2:] = 0.0
        out["Visibility"] = out["Visibility"].clone()
        out["Visibility"][h // 2:] = -1

    wrap(renderer, change)


def one_pixel_altered(renderer):
    def change(state, out):
        out["LDR"] = out["LDR"].clone()
        out["LDR"][0, 0] += 1.0  # one pixel a full display range off

    wrap(renderer, change)


FAULTS = {"none": None, "state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "one_pixel_altered": one_pixel_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(cell, fault):
    torch.set_num_threads(2)
    result, log = run_cell(cell, 2**31 + 77, 0.2, False, time.perf_counter(), device="cpu",
                           small=True, break_program=FAULTS[fault])
    assert result["correct"] is (fault == "none"), log["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
