"""Quickstart: the unified federated-algorithm API on a federated
classification task (twin of ``examples/quickstart.py``).

Every server variant implements ONE protocol (``init / round /
eval_params``), so the paper's headline comparison is three calls: build
algorithms by name from the registry, hand them to ``compare()`` with an
equal simulated-wall-clock budget, read the traces. 16 clients (30% slow),
non-iid by-class split.

Compression is composable the same way: QuAFL runs with (a) the default
8-bit lattice codec and (b) a PER-CLIENT heterogeneous uplink (fast clients
at b=8, the slow 30% packed at b=4), and FedPAQ-style compressed FedAvg
joins as just another registry name.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

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

FED = FedConfig(n_clients=16, s=4, local_steps=5, lr=0.3, bits=8, swt=10.0,
                quantizer="lattice")


def build(fed: FedConfig, params0, device):
    """The four runs of the comparison, by registry name."""
    def mk(name, **kw):
        return make_algorithm(name, fed, loss_fn=mlp_loss_batched,
                              template=params0, batch_size=32,
                              device=device, **kw)
    return {
        "quafl": mk("quafl"),
        # heterogeneous uplink: stragglers send 4-bit codes, fast clients 8
        "quafl_het": mk("quafl", uplink={"fast": "lattice",
                                         "slow": "lattice_packed:bits=4"}),
        "fedavg": mk("fedavg"),
        # FedPAQ-style compressed FedAvg: one registry name + one codec spec
        "fedpaq": mk("compressed_fedavg", uplink="scalar"),
    }


def setup(device, fed: FedConfig = FED):
    """(params0, per-client data, test set) from seed 0."""
    part, test = make_federated_classification(0, fed.n_clients, d=32,
                                               n_classes=10, iid=False,
                                               device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return init_mlp_classifier(gen, 32, 64, 10), part, test


def run(algs, params0, part, test, device, rounds: int = 120,
        fed: FedConfig = FED):
    """``compare`` at an equal simulated wall-clock: ``rounds`` QuAFL
    rounds' worth of time. FedAvg fits far fewer rounds in it, as its
    synchronous server waits for the slowest sampled client every round."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return compare(algs, params0, part, gen,
                   until_sim_time=rounds * (fed.swt + fed.sit),
                   eval_every=24,
                   eval_fn=lambda p: {"acc": float(mlp_loss(p, test)[1]
                                                   ["acc"])})


def report(traces) -> None:
    print("algorithm | rounds |  sim t |   acc | bits up | bits down")
    for name, tr in traces.items():
        f = tr.final
        print(f"{name:9s} | {tr.rounds:6d} | {f['sim_time']:6.0f} |"
              f" {f['acc']:5.3f} | {f['bits_up_total']:7.3g} |"
              f" {f['bits_down_total']:9.3g}")

    h, q = traces["quafl_het"].final, traces["quafl"].final
    print(f"\nheterogeneous uplink (slow 30% at b=4) sends "
          f"{q['bits_up_total'] / h['bits_up_total']:.2f}x fewer uplink "
          f"bits than uniform b=8 at acc {h['acc']:.3f} vs {q['acc']:.3f}")

    q, a = traces["quafl"].final, traces["fedavg"].final
    qbits = q["bits_up_total"] + q["bits_down_total"]
    abits = a["bits_up_total"] + a["bits_down_total"]
    ratio = ((abits / traces["fedavg"].rounds)
             / (qbits / traces["quafl"].rounds))
    print(f"\nQuAFL sends {ratio:.1f}x fewer bits per round than FedAvg at "
          f"the same simulated wall-clock budget")
    print(f"QuAFL slow-client zero-progress polls (last round): "
          f"{q['h_zero_frac']:.2f} — the algorithm tolerates them (paper §4)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card when "
                         "omitted")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    params0, part, test = setup(dev)
    traces = run(build(FED, params0, dev), params0, part, test, dev)
    report(traces)
    return traces


if __name__ == "__main__":
    main()
