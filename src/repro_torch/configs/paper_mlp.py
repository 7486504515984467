"""The paper's MNIST classifier (App. A.3): an MLP 784-32-10, the width of
``repro.configs.paper_mlp``."""
from __future__ import annotations

D_IN = 784
D_HIDDEN = 32
N_CLASSES = 10


def dims() -> tuple:
    """(d_in, d_hidden, n_classes) of the paper's MLP."""
    return D_IN, D_HIDDEN, N_CLASSES
