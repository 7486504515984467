"""Federated LM training through the registry (port of
``repro.launch.train``).

Every algorithm runs through the registry and ``simulate``, the mesh train
step included:

  * ``--algo spmd`` (default) — the mesh train step behind
    :class:`repro_torch.launch.spmd.SpmdAlgorithm`: one client per mesh
    data slice, the quantized exchange as collectives over the mesh's
    process groups, ``--transport`` choosing the exchange
    (``dequant_psum`` by default, ``code_allgather``, ``shard_local``,
    ``shard_local_codes``, ``shard_local_rs``). ``--mesh-data`` ×
    ``--mesh-model`` ranks, one process each: a single process runs the
    (1, 1) mesh; more ranks run under ``torchrun --nproc-per-node N``
    (gloo on the CPU, NCCL on cards, one card a rank), and a single process
    asked for more raises.
  * ``--algo quafl|fedavg|...`` — any other registry algorithm: each client's
    minibatch rows are sampled from its token pool
    (:func:`~repro_torch.data.synthetic.federated_token_task`) and the LM
    loss's gradient is taken one client at a time, then the exchange runs
    on the CUDA kernels by default. The mesh flags are read by ``spmd``
    only.

Rows print as the reference's (from rank 0).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --reduced --steps 4 --batch 4 --seq 64 --log-every 1 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --reduced --mesh-data 2 --steps 4 --batch 4 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 5 --batch 8 --seq 128 --log-every 1

The last runs on the card at the published width (1,235,814,400
parameters). Every decoder of the zoo trains the same way, e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --algo quafl --steps 5 --batch 8 --seq 128 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch deepseek-v2-236b --reduced --algo quafl --steps 2 --device cpu

(llama4, deepseek and jamba take cohort mode under ``--algo spmd``). It
runs on the card unless ``--device cpu`` asks for the CPU.
``--scan-chunk K`` runs the round engine's K-round chunks (CUDA graphs on
the card, the mesh's collectives and the MoE's grouped products captured
inside, every arch as the reference); ``--kernel-backend``
picks the exchange's CUDA kernels (``cuda``) or their plain versions
(``torch``); ``--checkpoint-dir`` saves the final ``eval_params`` in the
reference's checkpoint layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from functools import partial
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import default_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import federated_token_task, lm_token_stream
from repro_torch.fed import make_algorithm, simulate
from repro_torch.models.model import frontend_refusal, init_lm, lm_loss

EVAL_SEED = 999


class TrainRun(NamedTuple):
    trace: Any     # the simulate() trace
    alg: Any       # the registry algorithm
    data: Any      # {"tokens": (n_clients, pool, seq)}


def shape_template(params):
    """The params' shapes as meta tensors: the template an algorithm
    unflattens against, holding no memory."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in params.items()}


def init_distributed(device) -> torch.device:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment): join the
    process group — gloo on the CPU, NCCL on cards, rank r on card
    ``LOCAL_RANK`` — unless the caller already made one. Returns the
    device this rank runs on."""
    dev = default_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
    return dev


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def run_registry(args, cfg, fed: FedConfig, device=None) -> TrainRun:
    """Train through the registry and ``simulate``; prints a row every
    ``--log-every`` rounds and the engine line, as the reference."""
    why = frontend_refusal(cfg, "launch/train.py's token task")
    if why:
        raise NotImplementedError(why)
    dev = default_device(device)
    loss_fn = partial(lm_loss, cfg)
    # per-client token pool: every algorithm samples its minibatches with
    # replacement from these rows (the reference's sizing)
    pool = args.pool or max(256, max(4, args.local_steps) * args.batch)
    extra = {"batch_size": args.batch}
    if args.algo in ("fedbuff", "fedbuff_device"):
        extra["buffer_size"] = max(2, args.n_slots)
    elif args.algo == "spmd":
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((args.mesh_data, args.mesh_model),
                         ("data", "model"))
        extra = {"cfg": cfg, "mesh": mesh, "batch": args.batch,
                 "seq": args.seq, "seed": args.seed}
        # spmd maps ONE client per mesh data slice: the client count is
        # --mesh-data, not --n-slots
        if args.n_slots != args.mesh_data and is_rank0():
            print(f"[train] --algo spmd: client count comes from "
                  f"--mesh-data ({args.mesh_data}), overriding "
                  f"--n-slots {args.n_slots}", flush=True)
        fed = dataclasses.replace(fed, n_clients=args.mesh_data,
                                  s=args.mesh_data)
    data, batch_fn = federated_token_task(args.seed, fed.n_clients, pool,
                                          args.batch, args.seq,
                                          cfg.vocab_size, device=dev)
    params = [init_lm(cfg, seed=args.seed, device=dev)[0]]
    alg = make_algorithm(args.algo, fed, loss_fn=loss_fn,
                         template=shape_template(params[0]),
                         batch_fn=batch_fn, device=dev, **extra)
    gen = torch.Generator(device=dev)
    gen.manual_seed(EVAL_SEED)
    eval_toks = lm_token_stream(gen, args.batch, args.seq, cfg.vocab_size,
                                client_id=0)

    def eval_fn(p):
        with torch.no_grad():
            loss, _ = lm_loss(cfg, p, {"tokens": eval_toks})
        return {"server_loss": float(loss)}

    def on_row(row):
        if not is_rank0():
            return
        print(f"round {row['round']:5d} server_loss="
              f"{row.get('server_loss', float('nan')):.4f} "
              f"sim_t={row['sim_time']:.0f} "
              f"h_mean={row['h_steps_mean']:.2f} "
              f"qerr={row['quant_err']:.3e} "
              f"bits_up={row['bits_up_total']:.3g} "
              f"bits_down={row['bits_down_total']:.3g}"
              f" ({row['wall_time_s']:.1f}s)", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # simulate gets the only reference to the initial params, and drops
    # it once the algorithm's state holds them (a full-width copy less)
    trace = simulate(alg, params.pop(), data, gen, rounds=args.steps,
                     eval_every=args.log_every, eval_fn=eval_fn,
                     on_row=on_row, scan_chunk=args.scan_chunk)
    if is_rank0():
        print(f"engine={trace.engine} us_per_round="
              f"{trace.us_per_round:.0f}", flush=True)
    if args.checkpoint_dir:
        final = alg.eval_params(trace.final_state)   # every rank gathers
        if is_rank0():
            save_checkpoint(args.checkpoint_dir, trace.rounds, final,
                            extra={"arch": cfg.name, "algo": args.algo})
            print(f"checkpoint saved to {args.checkpoint_dir}", flush=True)
    return TrainRun(trace, alg, data)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--algo", default="spmd",
                    help="any registry name: spmd|quafl|fedavg|"
                         "compressed_fedavg|fedbuff|fedbuff_device|"
                         "sequential|quafl_scaffold|adaptive_quafl ('spmd' "
                         "= the mesh train step behind the same protocol)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-slots", type=int, default=2)
    ap.add_argument("--n-clients", type=int, default=0,
                    help="population size n (0 = --n-slots); the cohort "
                         "stays --n-slots")
    ap.add_argument("--participation", default="",
                    help="participation spec: uniform|"
                         "gamma_straggler[:strength=a]|"
                         "cyclic:period=P,phase_groups=G (empty = uniform)")
    ap.add_argument("--pool", type=int, default=0,
                    help="token-pool rows per client (0 = auto: at least "
                         "256)")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--quantizer", default="lattice")
    ap.add_argument("--codec-up", default="",
                    help="uplink codec spec (lattice|lattice_packed|topk_ef|"
                         "scalar|identity, with name:key=val params); empty "
                         "derives from --quantizer/--bits")
    ap.add_argument("--codec-down", default="",
                    help="downlink codec spec (as --codec-up)")
    ap.add_argument("--transport", default="dequant_psum",
                    help="mesh aggregation: dequant_psum|code_allgather|"
                         "shard_local|shard_local_codes|shard_local_rs "
                         "(the shard_local* family runs the shard-local "
                         "exchange with the psum / code all-gather / "
                         "reduce-scatter transport)")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=["cuda", "torch"],
                    help="the exchange's CUDA kernels, or their plain "
                         "PyTorch versions")
    ap.add_argument("--scan-chunk", default="0",
                    help=">=2 runs the round engine's K-round chunks (CUDA "
                         "graphs on the card); 'auto' picks K from a timed "
                         "probe")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="clients of the spmd mesh (its data axis)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks a client's blocks spread over (the spmd "
                         "mesh's model axis)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card when "
                         "omitted")
    args = ap.parse_args(argv)
    args.scan_chunk = (args.scan_chunk if args.scan_chunk == "auto"
                       else int(args.scan_chunk))
    return args


def fed_config(args) -> FedConfig:
    n_clients = args.n_clients or args.n_slots
    if n_clients < args.n_slots:
        raise SystemExit(f"--n-clients {n_clients} < --n-slots "
                         f"{args.n_slots}: cannot sample more clients per "
                         f"round than the population holds")
    return FedConfig(n_clients=n_clients, s=args.n_slots,
                     local_steps=args.local_steps, lr=args.lr,
                     bits=args.bits, quantizer=args.quantizer,
                     codec_up=args.codec_up, codec_down=args.codec_down,
                     transport=args.transport,
                     participation=args.participation,
                     kernel_backend=args.kernel_backend)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = init_distributed(args.device)
    return run_registry(args, cfg, fed_config(args), device=dev)


if __name__ == "__main__":
    main()
