"""The port's side of the gloo-rank cases of ``tests/test_torch_tools.py``:
the cases and the body of one rank. Imports neither JAX nor the reference,
so each of the 8 spawned processes loads only torch and the port.

Each rank of a (4, 2) data×model mesh runs:

* one reduced llama3.2-1b train step of each transport of
  :data:`TRANSPORTS` with the mesh recording its collectives; the records
  come back for the parent to hold equal to an abstract (4, 2) mesh's at
  the rank's coordinates;
* the reduced llama4-scout forward (``d_ff=256``, ``vocab_size=512``, the
  reference's ``tests/test_perf_variants.py`` case) and its mesh prefill
  step with ``moe.impl="ragged_shmap"`` on the reference's weights
  (``moe.npz``, written by the parent), for the parent to hold against the
  reference's ``impl="ragged"`` forward;
* the local steps of one train step (Y, every leaf whole, from the same
  state and batch) with ``ragged_shmap`` and with ``ragged``: each rank's
  gradient of its expert-FFN block, gathered back over 'model', and the
  input's gradient summed over it.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedConfig, ShapeConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import (build_prefill_step, build_train_step,
                                      init_train_state, rank_blocks,
                                      shard_train_state)
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import forward
from repro_torch.utils.interop import lm_params_from_numpy

RANKS, MESH = 8, (4, 2)
TRAIN_ARCH = "llama3.2-1b"
TRAIN_SHAPE = ShapeConfig("tiny", 32, 8, "train")
TRAIN_FED = dict(local_steps=2, lr=0.05, bits=8)
TRANSPORTS = ("dequant_psum", "code_allgather", "shard_local",
              "shard_local_codes", "shard_local_rs")
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_TOKENS = (4, 32)


def moe_config(impl: str):
    cfg = get_reduced(MOE_ARCH).replace(d_ff=256, vocab_size=512)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, impl=impl))


def train_records(mesh, transport: str):
    """One train step's collective records on this rank."""
    cfg, fed = get_reduced(TRAIN_ARCH), FedConfig(**TRAIN_FED)
    step, _, (specs, _) = build_train_step(cfg, fed, mesh, TRAIN_SHAPE,
                                           transport=transport, device="cpu")
    full = init_train_state(cfg, 0, step.n_slots, device="cpu")
    state = shard_train_state(full.server, full.clients, 0, mesh, specs)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                              dtype=v.dtype)
             for k, v in input_specs(cfg, TRAIN_SHAPE, n_slots=step.n_slots,
                                     local_steps=fed.local_steps).items()}
    with mesh.recording() as records:
        step(state, batch, generator=torch.Generator().manual_seed(2))
    return list(records)


def moe_outputs(mesh, out):
    """The ragged_shmap forward's logits on whole leaves, and the mesh
    prefill's last logits from the rank's blocks."""
    data = np.load(f"{out}/moe.npz")
    params = lm_params_from_numpy(
        {k[2:]: data[k] for k in data.files if k.startswith("p/")}, "cpu")
    tokens = torch.from_numpy(data["tokens"]).long()
    cfg = moe_config("ragged_shmap")
    moe_mod.set_moe_mesh(mesh)
    with torch.no_grad():
        logits = forward(cfg, params, {"tokens": tokens})[0]
        shape = ShapeConfig("p", tokens.shape[1], tokens.shape[0],
                            "prefill")
        step, _, (p_specs, b_specs) = build_prefill_step(cfg, mesh, shape)
        last, _ = step(rank_blocks(params, p_specs, mesh),
                       rank_blocks({"tokens": tokens.int()}, b_specs, mesh))
    return {"forward": logits.numpy(), "prefill_last": last.numpy()}


def moe_progress(mesh):
    """Y of this rank's client after K local steps, for 'ragged_shmap' and
    'ragged' (leaf -> array)."""
    shape = ShapeConfig("moe_train", 16, 4, "train")
    fed = FedConfig(**TRAIN_FED)
    ys = {}
    for impl in ("ragged_shmap", "ragged"):
        cfg = moe_config(impl)
        step, _, (specs, _) = build_train_step(cfg, fed, mesh, shape,
                                               device="cpu")
        full = init_train_state(cfg, 0, step.n_slots, device="cpu")
        state = shard_train_state(full.server, full.clients, 0, mesh, specs)
        gen = torch.Generator().manual_seed(3)
        batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                  dtype=v.dtype)
                 for k, v in input_specs(cfg, shape, n_slots=step.n_slots,
                                         local_steps=fed.local_steps
                                         ).items()}
        h = torch.tensor(fed.local_steps)
        y = step.progress(state, step.rank_batch(batch), h)
        ys[impl] = {k: v.detach().numpy() for k, v in y.items()}
    return ys


def run_rank(rank, world, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous",
                            rank=rank, world_size=world)
    mesh = make_mesh(MESH, ("data", "model"))
    res = {"coords": mesh.coords(),
           "records": {tr: train_records(mesh, tr) for tr in TRANSPORTS},
           "moe": moe_outputs(mesh, out),
           "moe_progress": moe_progress(mesh)}
    torch.save(res, f"{out}/tools_{rank}.pt")
    dist.destroy_process_group()
