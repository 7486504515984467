"""QuAFL-SCAFFOLD on non-iid data (beyond-paper, paper §5 future work;
twin of ``examples/scaffold_noniid.py``): controlled averaging removes the
non-iid client drift that slows vanilla QuAFL, and the control variates
ride the same position-aware quantized exchange. Both variants come out of
the algorithm registry and run under ``compare()`` with the same seeds and
budget.

    PYTHONPATH=src python -m repro_torch.examples.scaffold_noniid
    PYTHONPATH=src python -m repro_torch.examples.scaffold_noniid \\
        --device cpu

It runs on the card unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import default_device
from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import make_federated_classification
from repro_torch.fed import compare, make_algorithm
from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                    mlp_loss_batched)

FED = FedConfig(n_clients=16, s=4, local_steps=5, lr=0.3, bits=10, swt=10.0)


def run(device):
    """Vanilla QuAFL and QuAFL-SCAFFOLD through ``compare`` for 80 rounds,
    evaluated every 16, from seed 0 (data, weights) and seed 1 (the rounds'
    draws)."""
    part, test = make_federated_classification(0, FED.n_clients, d=32,
                                               n_classes=10, iid=False,
                                               device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params0 = init_mlp_classifier(gen, 32, 64, 10)
    algs = {name: make_algorithm(name, FED, loss_fn=mlp_loss_batched,
                                 template=params0, batch_size=32,
                                 device=device)
            for name in ("quafl", "quafl_scaffold")}
    gen.manual_seed(1)
    return compare(algs, params0, part, gen, rounds=80, eval_every=16,
                   eval_fn=lambda p: {"acc": float(mlp_loss(p, test)[1]
                                                   ["acc"])})


def report(traces) -> None:
    print("round |  vanilla acc | scaffold acc | ||c||")
    rows = zip(traces["quafl"].rows, traces["quafl_scaffold"].rows)
    for rv, rs in rows:
        print(f"{rv['round']:5d} | {rv['acc']:12.3f} | {rs['acc']:12.3f} |"
              f" {rs['c_norm']:.3f}")
    print("\nSCAFFOLD pays 2x the (cheap, quantized) communication for the "
          "drift correction — both messages are b-bit lattice codes.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card when "
                         "omitted")
    args = ap.parse_args(argv)
    traces = run(default_device(args.device))
    report(traces)
    return traces


if __name__ == "__main__":
    main()
