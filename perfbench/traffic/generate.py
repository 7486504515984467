"""The one traffic generator: it reads a traffic mix (a data file under
``perfbench/workloads/``) and makes the federation's data on the device
from the seed. ``data`` names the kind: ``classification`` (a Gaussian
mixture over the configuration's input width and classes, split among the
clients by class or at random) or ``tokens`` (a token pool a client, over
the configuration's vocabulary)."""
from __future__ import annotations

from perfbench.traffic import synthetic


def make(traffic: dict, cfg: dict, seed: int, device):
    kind = traffic["data"]
    if kind == "classification":
        return synthetic.federated_classification(
            seed, traffic["n_clients"], traffic["samples_per_client"],
            cfg["d_in"], cfg["n_classes"], traffic["iid"], device)
    if kind == "tokens":
        return {"tokens": synthetic.federated_tokens(
            seed, traffic["n_clients"], traffic["pool"], traffic["seq"],
            cfg["vocab_size"], device)}
    raise ValueError(f"unknown traffic data kind {kind!r}")


def pool_size(traffic: dict) -> int:
    """Rows a client's minibatches are drawn from."""
    if traffic["data"] == "classification":
        return traffic["samples_per_client"]
    return traffic["pool"]
