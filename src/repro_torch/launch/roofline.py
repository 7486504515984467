"""Roofline terms of one step on one NVIDIA H100 (port of
``repro.launch.roofline``).

Three terms, per (arch × shape × mesh), in seconds a step on one card,
from one rank's walk (``launch/hlocost.py``; the walk is of one rank's
step, so its numbers are per device):

  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = Σ_k bytes_k · RING_FACTOR_k / NVLINK_BW

The peaks are one H100 SXM's at its 700 W limit, from NVIDIA's H100 data
sheet: 989 TFLOP/s of dense bf16 on the tensor cores, 3.35 TB/s of HBM3,
and 450 GB/s of NVLink 4 each way (900 GB/s both ways, 18 links).

The reference reads its collectives' bytes from XLA's HLO text
(``parse_collectives``); the port has no HLO. Its mesh records each
collective as it runs it (``launch/mesh.py``, ``Mesh.records``), and
:func:`repro_torch.launch.hlocost.collectives_of` sums the results' bytes
by kind, the quantity ``parse_collectives`` summed. The ring factors are
the reference's: an all-reduce moves its bytes twice (reduce-scatter then
all-gather).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# NVIDIA H100 SXM (H100 Tensor Core GPU data sheet), 700 W
PEAK_FLOPS = 989e12       # dense bf16, tensor cores
HBM_BW = 3.35e12          # HBM3, bytes/s
NVLINK_BW = 450e9         # NVLink 4, bytes/s each way

RING_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_seconds(coll: Dict[str, Dict[str, float]]) -> float:
    return sum(v["bytes"] * RING_FACTOR.get(k, 1.0) / NVLINK_BW
               for k, v in coll.items())


def roofline(flops: float, bytes_accessed: float,
             coll: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    t_c = flops / PEAK_FLOPS
    t_m = bytes_accessed / HBM_BW
    t_x = collective_seconds(coll)
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE)
# ---------------------------------------------------------------------------

def active_params(cfg) -> float:
    """Activated parameter count (expert leaves scaled by top_k/E)."""
    from repro_torch.models.model import abstract_lm
    spec, axes = abstract_lm(cfg)
    total = 0.0
    for k, v in spec.items():
        n = float(np.prod(v.shape))
        if axes[k] and "experts" in axes[k] and cfg.moe and "router" not in k:
            n *= cfg.moe.top_k / cfg.moe.n_experts
        total += n
    return total


def tokens_per_step(cfg, shape, local_steps: int, n_slots: int) -> float:
    if shape.kind == "train":
        b_local = max(shape.global_batch // n_slots, 1)
        return n_slots * local_steps * b_local * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one token per sequence


def model_flops(cfg, shape, local_steps: int, n_slots: int) -> float:
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd = 3x fwd
    return 2.0 * active_params(cfg) * tokens_per_step(
        cfg, shape, local_steps, n_slots) * mult
