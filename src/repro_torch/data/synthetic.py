"""Synthetic federated classification data (port of the classification
half of ``repro.data.synthetic``).

A Gaussian mixture stands in for MNIST: class means ~ N(0, sep²/d), samples
mean + N(0, I). The federation is a fixed random split (i.i.d.) or a
by-class split where each client holds a contiguous run of the class-sorted
samples (the paper's 'pure non-i.i.d.' setting). Draws come from a
``torch.Generator``; data lives on the generator's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import default_device


def gaussian_mixture(generator: torch.Generator, n_samples: int, d: int = 32,
                     n_classes: int = 10, sep: float = 3.0, mus=None
                     ) -> Dict[str, torch.Tensor]:
    """{'x': (n, d) fp32, 'y': (n,) int64}; ``mus`` (n_classes, d) reuses
    given class means (train and test share them)."""
    dev = generator.device
    if mus is None:
        mus = torch.randn((n_classes, d), generator=generator,
                          device=dev) * (sep / np.sqrt(d))
    y = torch.randint(0, n_classes, (n_samples,), generator=generator,
                      device=dev)
    x = mus[y] + torch.randn((n_samples, d), generator=generator, device=dev)
    return {"x": x, "y": y, "mus": mus}


def partition_iid(generator: torch.Generator, data, n_clients: int):
    """Fixed random split — each client gets a 1/n partition."""
    n = data["y"].shape[0]
    m = n // n_clients
    perm = torch.randperm(n, generator=generator,
                          device=generator.device)[: m * n_clients]
    idx = perm.reshape(n_clients, m)
    return {k: data[k][idx] for k in ("x", "y")}  # leaves (n_clients, m, ...)


def partition_by_class(generator: torch.Generator, data, n_clients: int,
                       n_classes: int):
    """Pure non-i.i.d.: the class-sorted samples cut into n contiguous runs,
    so each client holds few classes; runs go to clients in random order."""
    order = torch.sort(data["y"], stable=True).indices
    m = order.shape[0] // n_clients
    idx = order[: m * n_clients].reshape(n_clients, m)
    perm = torch.randperm(n_clients, generator=generator,
                          device=generator.device)
    idx = idx[perm]
    return {k: data[k][idx] for k in ("x", "y")}


def make_federated_classification(seed: int, n_clients: int,
                                  samples_per_client: int = 256, d: int = 32,
                                  n_classes: int = 10, iid: bool = True,
                                  test_samples: int = 1024, device=None):
    """(per-client partition {'x': (n, m, d), 'y': (n, m)}, test set)."""
    dev = default_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    train = gaussian_mixture(gen, n_clients * samples_per_client, d,
                             n_classes)
    test = gaussian_mixture(gen, test_samples, d, n_classes,
                            mus=train["mus"])
    part = (partition_iid(gen, train, n_clients) if iid
            else partition_by_class(gen, train, n_clients, n_classes))
    return part, {"x": test["x"], "y": test["y"]}


def client_batch(generator: torch.Generator, client_data, batch: int):
    """A minibatch, drawn with replacement, from one client's partition
    {'x': (m, d), 'y': (m,)}."""
    m = client_data["y"].shape[0]
    idx = torch.randint(0, m, (batch,), generator=generator,
                        device=generator.device)
    return {k: v[idx] for k, v in client_data.items()}
