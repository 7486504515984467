"""Synthetic federated data, made on the device from a seed: a frozen copy
of the program's generators, so that no change to the program moves the
benchmark's inputs.

* Classification: a Gaussian mixture stands in for MNIST (class means ~
  N(0, sep^2/d), samples mean + N(0, I)); the federation splits the
  class-sorted samples into n contiguous runs (the paper's pure non-iid
  setting) or at random.
* Language modelling: each client's token rows follow a Zipf law over the
  vocabulary under a per-client pseudo-permutation (the non-iid knob).
"""
from __future__ import annotations

import math

import torch


def gaussian_mixture(gen: torch.Generator, n_samples: int, d: int,
                     n_classes: int, sep: float = 3.0, mus=None):
    dev = gen.device
    if mus is None:
        mus = torch.randn((n_classes, d), generator=gen,
                          device=dev) * (sep / math.sqrt(d))
    y = torch.randint(0, n_classes, (n_samples,), generator=gen, device=dev)
    x = mus[y] + torch.randn((n_samples, d), generator=gen, device=dev)
    return {"x": x, "y": y, "mus": mus}


def partition_iid(gen: torch.Generator, data, n_clients: int):
    n = data["y"].shape[0]
    m = n // n_clients
    perm = torch.randperm(n, generator=gen, device=gen.device)[: m * n_clients]
    idx = perm.reshape(n_clients, m)
    return {k: data[k][idx] for k in ("x", "y")}


def partition_by_class(gen: torch.Generator, data, n_clients: int):
    order = torch.sort(data["y"], stable=True).indices
    m = order.shape[0] // n_clients
    idx = order[: m * n_clients].reshape(n_clients, m)
    idx = idx[torch.randperm(n_clients, generator=gen, device=gen.device)]
    return {k: data[k][idx] for k in ("x", "y")}


def federated_classification(seed: int, n_clients: int, samples: int,
                             d: int, n_classes: int, iid: bool, device):
    """{'x': (n, m, d) fp32, 'y': (n, m) int64} on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    train = gaussian_mixture(gen, n_clients * samples, d, n_classes)
    split = partition_iid if iid else partition_by_class
    return split(gen, train, n_clients)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    return (x + 2**31) % 2**32 - 2**31


def token_rows(gen: torch.Generator, rows: int, seq: int, vocab: int,
               client_id: int, zipf_a: float = 1.2) -> torch.Tensor:
    """(rows, seq) int32: inverse-CDF Zipf draws, then token' = (token ·
    (prime + 2·client + 1) + client · 7919) mod vocab in wrapping int32
    arithmetic, prime = 1,000,003 mod vocab."""
    u = torch.rand((rows, seq), generator=gen, device=gen.device)
    ranks = torch.arange(vocab, dtype=torch.float32, device=gen.device)
    w = (ranks + 1.0) ** (-zipf_a)
    cdf = torch.cumsum(w, 0) / torch.sum(w)
    tok = torch.searchsorted(cdf, u).clamp_(max=vocab - 1).to(torch.int64)
    prime = 1_000_003 % vocab
    tok = _wrap_int32(_wrap_int32(tok * (prime + 2 * client_id + 1))
                      + client_id * 7919)
    return torch.remainder(tok, vocab).to(torch.int32)


def federated_tokens(seed: int, n_clients: int, pool: int, seq: int,
                     vocab: int, device) -> torch.Tensor:
    """(n_clients, pool, seq) int32 token pools, client by client from one
    generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.stack([token_rows(gen, pool, seq, vocab, i)
                        for i in range(n_clients)])
