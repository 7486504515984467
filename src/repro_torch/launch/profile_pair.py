"""Dry-run profiler: print the top memory-traffic contributors of one
(arch × shape) pair, the napkin-math tool (port of
``repro.launch.profile_pair``).

  PYTHONPATH=src python -m repro_torch.launch.profile_pair \\
      --arch deepseek-v2-236b --shape prefill_32k

The pair is rebuilt as ``launch/dryrun.lower_pair`` builds it (rank 0 of
the abstract production mesh, ``meta`` tensors) and walked with the op-cost
walker keeping its records (``launch/hlocost.py``); each line is one (op,
line of the port) pair: its bytes, the calls folded into it (the
reference's trip-count multiplier), the op and where it ran.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import FedConfig
from repro_torch.launch.dryrun import pair_config, walk_step
from repro_torch.launch.hlocost import top_contributors
from repro_torch.launch.mesh import make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--transport", default="dequant_psum")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                abstract=True)
    fed = FedConfig(local_steps=2)
    cfg, shape = pair_config(args.arch, args.shape, mesh)
    walker = walk_step(cfg, shape, mesh, fed, transport=args.transport,
                       records=True)[0]
    for r in top_contributors(walker, args.top):
        print(f"{r['bytes']:.3e}B  x{r['count']:g}  {r['op']:<14s} "
              f"{r['where'][:130]}")


if __name__ == "__main__":
    main()
