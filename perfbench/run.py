"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload mlp_quafl_paper --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``checks``); the line before it holds observations
that are not metrics (clocks and power beside the window, cold or warm
build, the set-up's parts). The last lines of standard error give each
compared number beside its limit. A machine without the card the cell
asks for exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program stays at a fixed place in
# the checkout, so that only a checkout's first run builds
_CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
           "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv_compute"}
for _var, _dir in _CACHES.items():
    os.environ[_var] = str(ROOT / "build" / _dir)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from perfbench import harness
    cell = harness.find_cell(ROOT, args.workload)
    try:
        dev = harness.require_chips(cell.chips)
    except harness.NoChip as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=T_START, dev=dev)
    result = harness.execute(run)
    print(json.dumps({"observations": run.obs}), flush=True)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
