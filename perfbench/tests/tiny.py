"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same files, with the federation and the model shrunk in
memory."""
from __future__ import annotations

import time

import torch

from perfbench import harness
from perfbench.tests.conftest import ROOT

TINY = {
    "mlp_quafl_paper": ({}, dict(n_clients=8, s=4, local_steps=2,
                                 samples_per_client=64, engine_chunk=2,
                                 check_rounds=2, trace_rounds=4)),
    "olmo1b_quafl_b8": (dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                             head_dim=16, d_ff=128, vocab_size=256,
                             compute_dtype="float32"),
                        dict(pool=16, seq=16, batch=4, check_rounds=2,
                             trace_rounds=2)),
}


def cell(name: str, root=ROOT, compute_dtype=None):
    c = harness.find_cell(root, name)
    cfg, tr = TINY[name]
    c.config.update(cfg)
    if compute_dtype:
        c.config["compute_dtype"] = compute_dtype
    c.traffic.update(tr)
    return c


def run(c, trace=False, seed=2**33 + 5, seconds=0.5, plant=None):
    """One run of ``c`` on the CPU, the harness's look for a chip skipped;
    returns (result, observations)."""
    r = harness.Run(cell=c, seed=seed, seconds=seconds, trace=trace,
                    t_start=time.perf_counter(), dev=torch.device("cpu"))
    return harness.execute(r, plant=plant), r.obs
