"""Synthetic federated data (port of ``repro.data.synthetic``).

A Gaussian mixture stands in for MNIST: class means ~ N(0, sep²/d), samples
mean + N(0, I). The federation is a fixed random split (i.i.d.) or a
by-class split where each client holds a contiguous run of the class-sorted
samples (the paper's 'pure non-i.i.d.' setting).

For the LM architectures, per-client token streams come from a Zipf law
over the vocabulary with a per-client pseudo-permutation (the non-iid
knob). :func:`federated_token_task` gives the LM task in the shape the
algorithms' ``batch_fn`` protocol takes.

Draws come from a ``torch.Generator``; data lives on the generator's
device.
"""
from __future__ import annotations

from typing import Dict, Optional

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


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's complement, as int32 arithmetic
    that overflows wraps."""
    return (x + 2**31) % 2**32 - 2**31


def lm_token_stream(generator: Optional[torch.Generator], batch: int,
                    seq_len: int, vocab: int, client_id: int = 0,
                    zipf_a: float = 1.2, u: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(batch, seq_len) int32 tokens: inverse-CDF samples of p(r) ∝
    (r+1)^-a, then the client's pseudo-permutation token' = (token ·
    (prime + 2·client_id + 1) + client_id · 7919) mod vocab, prime =
    1,000,003 mod vocab. ``u`` (batch, seq_len) replaces the uniform draws
    (then ``generator`` may be None).

    The map runs in int32 with wraparound, as the reference's does: at
    vocab 128,256 the product overflows int32, and the reference's tokens
    are the wrapped ones."""
    if u is None:
        u = torch.rand((batch, seq_len), generator=generator,
                       device=generator.device)
    u = u.to(torch.float32)
    ranks = torch.arange(vocab, dtype=torch.float32, device=u.device)
    w = (ranks + 1.0) ** (-zipf_a)
    cdf = torch.cumsum(w, 0) / torch.sum(w)
    tok = torch.searchsorted(cdf, u).to(torch.int64)
    prime = 1_000_003 % vocab
    tok = _wrap_int32(_wrap_int32(tok * (prime + 2 * client_id + 1))
                      + client_id * 7919)
    return torch.remainder(tok, vocab).to(torch.int32)


def make_federated_tokens(seed: int, n_clients: int, batch: int,
                          seq_len: int, vocab: int, noniid: bool = True,
                          device=None, u: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(n_clients, batch, seq_len) int32 token rows, client by client from
    one generator seeded with ``seed``; ``u`` (n_clients, batch, seq_len)
    replaces the uniform draws."""
    dev = default_device(device)
    gen = None
    if u is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    return torch.stack([lm_token_stream(
        gen, batch, seq_len, vocab, client_id=(i if noniid else 0),
        u=None if u is None else u[i].to(dev)) for i in range(n_clients)])


def token_batch(client_data, rows: torch.Tensor):
    """The ``batch_fn`` of the LM task: the given (B,) rows of one client's
    token pool, ``{"tokens": (B, seq_len)}``."""
    return {"tokens": client_data["tokens"][rows]}


def federated_token_task(seed: int, n_clients: int, pool: int, batch: int,
                         seq_len: int, vocab: int, device=None,
                         u: Optional[torch.Tensor] = None):
    """An LM task in the shape the algorithms' ``batch_fn`` protocol takes:
    ``(data, batch_fn)``, ``data = {"tokens": (n_clients, pool, seq_len)}``
    and ``batch_fn(client_data, rows)`` the rows of one client's pool.

    The algorithm draws each minibatch's ``batch`` row indices (uniform over
    the pool, with replacement, as the reference's ``randint``) and passes
    them in, so a test can inject the reference's draws. ``batch`` is
    accepted for the reference's signature; the algorithms take it as
    ``batch_size``. ``u`` as :func:`make_federated_tokens`'s."""
    del batch
    data = {"tokens": make_federated_tokens(seed, n_clients, pool, seq_len,
                                            vocab, device=device, u=u)}
    return data, token_batch
