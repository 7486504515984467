"""Client heterogeneity demo (paper §2.1 + Fig. 3; twin of
``examples/heterogeneous_clients.py``): QuAFL with fast/slow clients,
weighted (η_i = H_min/H_i) vs unweighted dampening, and the robustness
headline — slow clients sometimes contribute ZERO local steps and the
algorithm still converges. Runs through ``simulate()``; the zero-progress
fraction comes straight off the trace rows.

Heterogeneity also extends to the WIRE: a ``{"fast": ..., "slow": ...}``
uplink codec spec gives each speed class its own bit budget (the slow 30%
upload 4-bit packed lattice codes, fast clients keep 8 bits), and to WHO
ANSWERS the poll: a participation spec swaps uniform sampling for cyclic
availability at the SAME simulated clock budget.

    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_clients
    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_clients \\
        --device cpu

It runs on the card unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import make_federated_classification
from repro_torch.fed import (client_speeds, expected_steps, make_algorithm,
                             simulate)
from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                    mlp_loss_batched)


def run(device, weighted: bool, swt: float, rounds: int = 120, uplink=None,
        bits: int = 10, participation: str = ""):
    fed = FedConfig(n_clients=20, s=5, local_steps=10, lr=0.3, bits=bits,
                    swt=swt, slow_frac=0.3, lam_slow=1 / 16,
                    weighted=weighted, participation=participation)
    part, test = make_federated_classification(0, fed.n_clients, d=32,
                                               n_classes=10, iid=False,
                                               device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params0 = init_mlp_classifier(gen, 32, 64, 10)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched,
                         template=params0, batch_size=32, uplink=uplink,
                         device=device)
    # record_every=1 traces every round's h_zero_frac; the test-set eval
    # runs ONCE, on the final round (eval_every=0 -> eval only at done)
    gen.manual_seed(1)
    trace = simulate(alg, params0, part, gen, rounds=rounds, eval_every=0,
                     record_every=1,
                     eval_fn=lambda p: {"acc": float(mlp_loss(p, test)[1]
                                                     ["acc"])})
    zero_frac = float(np.mean(trace.column("h_zero_frac")))
    return trace, zero_frac, alg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card when "
                         "omitted")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    fed = FedConfig(n_clients=20, slow_frac=0.3, lam_slow=1 / 16,
                    local_steps=10, swt=2.0)
    lam = client_speeds(fed, 20)
    H = expected_steps(fed, lam)
    print("client speeds λ:", np.unique(lam),
          " expected steps H_i:", np.unique(H.round(2)))
    for weighted in (False, True):
        tr, zf, alg = run(dev, weighted, swt=2.0)
        print(f"weighted={weighted}:  acc={tr.final['acc']:.3f}  "
              f"zero-progress polls={zf:.1%}  η_i∈[{alg.eta_i.min():.2f},"
              f"{alg.eta_i.max():.2f}]")
    print("\n(paper §4: QuAFL tolerates a large fraction of slow clients "
          "submitting infrequent or even empty updates)")

    # --- heterogeneous bit budgets: slow clients at b=4, fast at b=8 ------
    tr_u, _, _ = run(dev, False, swt=2.0, bits=8)
    tr_h, _, alg_h = run(dev, False, swt=2.0, bits=8,
                         uplink={"fast": "lattice",
                                 "slow": "lattice_packed:bits=4"})
    bits_pc = np.asarray(alg_h.codec_up.bits_per_client)
    print(f"\nheterogeneous codecs: per-client uplink bits "
          f"{dict(zip(*np.unique(bits_pc, return_counts=True)))}")
    print(f"uniform b=8:      acc={tr_u.final['acc']:.3f}  "
          f"uplink bits={tr_u.final['bits_up_total']:.3g}")
    print(f"fast b=8/slow b=4: acc={tr_h.final['acc']:.3f}  "
          f"uplink bits={tr_h.final['bits_up_total']:.3g}  "
          f"({tr_u.final['bits_up_total'] / tr_h.final['bits_up_total']:.2f}"
          f"x fewer — stragglers answer on half the per-coordinate bit "
          f"budget)")

    # --- participation: cyclic availability vs uniform, equal clock -------
    # QuAFL rounds all cost swt+sit, so equal rounds IS equal sim-time; the
    # cyclic spec makes only one of 4 phase groups (5 of 20 clients)
    # reachable per 2-round window — the poll must take whoever is awake.
    tr_cyc, _, _ = run(dev, False, swt=2.0, bits=8,
                       participation="cyclic:period=8,phase_groups=4")
    print(f"\nparticipation at equal sim-time "
          f"(sim_t={tr_u.final['sim_time']:.0f}s == "
          f"{tr_cyc.final['sim_time']:.0f}s):")
    print(f"uniform polling:      acc={tr_u.final['acc']:.3f}")
    print(f"cyclic availability:  acc={tr_cyc.final['acc']:.3f}  "
          f"(gap {tr_u.final['acc'] - tr_cyc.final['acc']:+.3f} — periodic "
          f"client availability is a config axis, not a code change)")
    return {"uniform": tr_u, "grouped": tr_h, "cyclic": tr_cyc}


if __name__ == "__main__":
    main()
