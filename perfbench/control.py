"""The control and the planted faults: readings that the comparison must
refuse, at a cell's own size, on the card.

For each seed the reference runs the cell's check rounds from the cell's
inputs in fp32 (the yardstick), then again as each variant, and the
variant's state is compared with the yardstick's exactly as the program's
is in a run:

* ``control``: the reference in the nearest precision below the one the
  configuration computes in (fp32 -> TF32 operands; bf16 -> fp8 e4m3
  operands in every product, forward and backward, activations held in
  bf16 as the program holds them);
* ``half_batch``: every local step's gradient over half its minibatch;
* ``no_exchange``: the server keeps X_t and each client its local model
  (the exchange and the averaging left out);
* ``answer_altered``: the new server row's first Hadamard block zeroed
  where the exchange produces it (an answer altered where it is made).

Where the configuration computes in bf16, ``witness`` is the reference
with its products in bf16: what a sound bf16 program should read.

A state left unchanged reads 1 by construction and needs no run. The
limits in ``limits/<cell>.json`` lie between the program's readings and
these. ``--program`` reads the program instead: one whole run of the cell
a seed (the window ``--seconds`` long, the last ``--traced`` seeds under
the profiler), all in one process, with every compared number.

    python3 perfbench/control.py --workload olmo1b_quafl_b8 --seeds 1 2 3
    python3 perfbench/control.py --workload olmo1b_quafl_b8 --program \
        --seconds 1 --traced 3 --seeds 1 2 3 4 5 6 7 8 9 10 11 12
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
VARIANTS = ("control", "half_batch", "no_exchange", "answer_altered")
# the reference computing in the configuration's own lower precision: a
# second witness beside the program, where the configuration states one
WITNESS = {"bfloat16": "bf16"}


def to_host(d: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            if hasattr(v, "detach") and v.device.type != "cpu" else v
            for k, v in d.items()}


def readings(cell, seed: int, dev, variants=VARIANTS) -> dict:
    """{variant: compared numbers} for one seed."""
    import torch

    from perfbench import compare, harness
    from perfbench.reference import precision
    from perfbench.traffic import generate
    precision.fp32_only()
    leaves = harness.leaves_of(cell)
    data = generate.make(cell.traffic, cell.config,
                         harness.sub_seed(seed, "data"), dev)
    wseed = harness.sub_seed(seed, "weights")
    draw = cell.traffic["draw_seed"]
    rounds = cell.traffic["check_rounds"]
    x0 = harness.make_weights(leaves, wseed, dev)
    sample = (compare.sample_indices(leaves, harness.sub_seed(seed, "sample"),
                                     dev)
              if cell.traffic["engine_chunk"] == 0 else None)
    base = to_host(compare.state_dict(
        harness.reference_state(cell, data, x0, draw, rounds,
                                sample=sample)))
    out = {}
    dtype = cell.config["compute_dtype"]
    if dtype in WITNESS:
        variants = ("witness",) + tuple(variants)
    for v in variants:
        mode = {"control": CONTROL[dtype],
                "witness": WITNESS.get(dtype)}.get(v, "float32")
        fault = None if v in ("control", "witness") else v
        st = harness.reference_state(cell, data, x0, draw, rounds, mode=mode,
                                     fault=fault, sample=sample)
        nums = compare.numbers(compare.state_dict(st), base, x0, leaves)
        leaf = nums.pop("leaf_gaps")
        nums["step1_leaves"] = leaf["step1"]
        nums["grad1_leaves"] = leaf["grad1"]
        out[v] = nums
        del st
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def program(cell, seed: int, dev, seconds: float, trace: bool) -> dict:
    """One run of the program in this process: its compared numbers, the
    verdict and the metrics."""
    import time

    from perfbench import harness
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                      t_start=time.perf_counter(), dev=dev)
    res = harness.execute(run)
    return {"correct": res["correct"], "checks": res["checks"],
            "numbers": run.obs["numbers"], "metrics": res["metrics"],
            "setup_s": run.obs["setup_s"],
            "reference_s": run.obs["reference_s"],
            "grad1_leaves": run.obs["leaf_gaps"]["grad1"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--traced", type=int, default=0)
    args = ap.parse_args(argv)
    if args.program:
        # the build caches and the program's path, as a run has them
        from perfbench import run as _run  # noqa: F401
    from perfbench import harness
    cell = harness.find_cell(ROOT, args.workload)
    dev = harness.require_chips(cell.chips)
    for i, seed in enumerate(args.seeds):
        if args.program:
            trace = i >= len(args.seeds) - args.traced
            out = {"program": program(cell, seed, dev, args.seconds, trace)}
        else:
            out = {"readings": readings(cell, seed, dev)}
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
