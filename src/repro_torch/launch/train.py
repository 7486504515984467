"""Federated LM training through the registry (port of the registry path of
``repro.launch.train``).

Any registry algorithm trains any ported decoder: the algorithm samples
each client's minibatch rows from a per-client token pool
(:func:`~repro_torch.data.synthetic.federated_token_task`) and takes the
LM loss's gradient one client at a time (the per-client protocol of
:mod:`repro_torch.fed.registry`), then runs its exchange, on the CUDA
kernels by default. Rows print as the reference's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --reduced --steps 4 --batch 4 --seq 64 --log-every 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --algo quafl --steps 5 --batch 8 --seq 128 --log-every 1

The second runs on the card at the published width (1,235,814,400
parameters; about 15 fp32 copies of the model live at once at n = s = 2).
It runs on the card unless ``--device cpu`` asks for the CPU.
``--scan-chunk K`` runs the round engine's K-round chunks (CUDA graphs on
the card); ``--kernel-backend`` picks the exchange's CUDA kernels
(``cuda``) or their plain versions (``torch``); ``--checkpoint-dir`` saves
the final ``eval_params`` in the reference's checkpoint layout.

The reference's default ``--algo spmd`` (the mesh-sharded train step) and
the flags only the mesh path reads (``--transport``, ``--mesh-data``,
``--mesh-model``) raise ``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import argparse
from functools import partial
from typing import Any, NamedTuple

import torch

from repro_torch import default_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import federated_token_task, lm_token_stream
from repro_torch.fed import make_algorithm, simulate
from repro_torch.models.model import init_lm, lm_loss

MESH_ONLY = "the mesh path (ROADMAP Queue 1 item 11) is not ported yet"
# the reference's defaults of the flags only its mesh path reads
MESH_DEFAULTS = {"transport": "dequant_psum", "mesh_data": 1, "mesh_model": 1}
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


def refuse_mesh_flags(args) -> None:
    if args.algo == "spmd":
        raise NotImplementedError(f"--algo spmd: {MESH_ONLY}")
    for flag, default in MESH_DEFAULTS.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {getattr(args, flag)}: only the "
                f"mesh path reads it, and {MESH_ONLY}")


def run_registry(args, cfg, fed: FedConfig, device=None) -> TrainRun:
    """Train through the registry and ``simulate``; prints a row every
    ``--log-every`` rounds and the engine line, as the reference."""
    refuse_mesh_flags(args)
    dev = default_device(device)
    loss_fn = partial(lm_loss, cfg)
    # per-client token pool: every algorithm samples its minibatches with
    # replacement from these rows (the reference's sizing)
    pool = args.pool or max(256, max(4, args.local_steps) * args.batch)
    extra = {}
    if args.algo in ("fedbuff", "fedbuff_device"):
        extra = {"buffer_size": max(2, args.n_slots)}
    data, batch_fn = federated_token_task(args.seed, fed.n_clients, pool,
                                          args.batch, args.seq,
                                          cfg.vocab_size, device=dev)
    params = [init_lm(cfg, seed=args.seed, device=dev)[0]]
    alg = make_algorithm(args.algo, fed, loss_fn=loss_fn,
                         template=shape_template(params[0]),
                         batch_fn=batch_fn, batch_size=args.batch,
                         device=dev, **extra)
    gen = torch.Generator(device=dev)
    gen.manual_seed(EVAL_SEED)
    eval_toks = lm_token_stream(gen, args.batch, args.seq, cfg.vocab_size,
                                client_id=0)

    def eval_fn(p):
        with torch.no_grad():
            loss, _ = lm_loss(cfg, p, {"tokens": eval_toks})
        return {"server_loss": float(loss)}

    def on_row(row):
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
    print(f"engine={trace.engine} us_per_round={trace.us_per_round:.0f}",
          flush=True)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, trace.rounds,
                        alg.eval_params(trace.final_state),
                        extra={"arch": cfg.name, "algo": args.algo})
        print(f"checkpoint saved to {args.checkpoint_dir}", flush=True)
    return TrainRun(trace, alg, data)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--algo", default="quafl",
                    help="any registry name: quafl|fedavg|compressed_fedavg|"
                         "fedbuff|fedbuff_device|sequential|quafl_scaffold|"
                         "adaptive_quafl ('spmd', the mesh path, is not "
                         "ported yet)")
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
    ap.add_argument("--transport", default=MESH_DEFAULTS["transport"],
                    help="mesh aggregation (the mesh path only; not ported "
                         "yet)")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=["cuda", "torch"],
                    help="the exchange's CUDA kernels, or their plain "
                         "PyTorch versions")
    ap.add_argument("--scan-chunk", default="0",
                    help=">=2 runs the round engine's K-round chunks (CUDA "
                         "graphs on the card); 'auto' picks K from a timed "
                         "probe")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
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
                     participation=args.participation,
                     kernel_backend=args.kernel_backend)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    refuse_mesh_flags(args)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    return run_registry(args, cfg, fed_config(args), device=args.device)


if __name__ == "__main__":
    main()
