"""Models of the port (port of ``repro.models``): the paper's MLP
classifier and the decoder-only LM zoo (dense, MoE, MLA, Mamba2, hybrid)."""
from repro_torch.models.model import (decode_step, forward,  # noqa: F401
                                      init_cache, init_lm, lm_loss)
