"""The paper's MLP under the program: the registry's QuAFL with the
batched client protocol (``models.mlp.mlp_loss_batched``)."""
from __future__ import annotations

import torch


def build(cfg, traffic, leaves, device, fed):
    """The registry's algorithm for the cell; ``leaves`` is the flat
    layout the benchmark makes the initial model in."""
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.models.mlp import mlp_loss_batched
    template = {name: torch.empty(shape, device="meta")
                for name, shape, _ in leaves}
    return make_algorithm(traffic["algorithm"], fed, loss_fn=mlp_loss_batched,
                          template=template, batch_size=traffic["batch"],
                          device=device)
