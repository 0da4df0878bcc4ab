#!/usr/bin/env python3
"""Run one benchmark cell once on the card and print its result line.

    python3 perfbench/run.py --workload stress.animated --seed 7 --seconds 51 --trace 0

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic mix
and metrics, each from its own file under ``perfbench/``), builds the
scene and the renderer, warms up every graph the cell replays, renders
frames for ``--seconds`` in a closed loop, checks the frames against the
configuration's plain reference (``reference/``), and prints the log (each compared number beside its limit
last) on standard error and one JSON object as the last line of standard
output. ``--trace 1`` reports the per-layer metrics in place of the
end-to-end ones. Needs as many CUDA devices as the cell asks for; the
kernels build into ``build/kernels/`` of this checkout at the first run."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache the run could write stays in this checkout, at fixed paths.
    cache = ROOT / "build" / "perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from perfbench.lib.spec import Spec

    spec = Spec()
    chips = int(spec.cell(args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from perfbench.lib.harness import log_lines, run_cell

    result, log = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0,
                           spec=spec)
    for line in log_lines(result, log):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
