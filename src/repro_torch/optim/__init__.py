from repro_torch.optim.optim import (  # noqa: F401
    AdamState, Optimizer, adam, sgd)
