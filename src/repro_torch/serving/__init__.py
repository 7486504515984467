"""Batched LM serving (port of ``repro.serving``)."""
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
