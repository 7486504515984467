"""Serving driver: batched requests against any decoder of the zoo
through the ServeEngine (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --device cpu    # also deepseek-v2-236b, llama4-scout-17b-a16e,
                      # jamba-1.5-large-398b, gemma3-12b

It runs on the card unless ``--device cpu`` asks for the CPU. Weights are a
fresh init from ``--seed`` (``--full``: the architecture's published
widths; else its reduced member). With ``--from-algo NAME`` the served
weights are the ``eval_params`` of a short federated run of that registry
algorithm on the LM token task (``--algo-rounds`` rounds, 4 clients), as
the reference's:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --from-algo quafl --algo-rounds 5 --requests 4 --device cpu
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FedConfig
from repro_torch.data.synthetic import federated_token_task
from repro_torch.fed import make_algorithm, simulate
from repro_torch.models.model import frontend_refusal, init_lm, lm_loss
from repro_torch.serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card when "
                         "omitted")
    ap.add_argument("--from-algo", default="",
                    help="registry algorithm whose eval_params to serve "
                         "(quafl|fedavg|fedbuff|sequential|...)")
    ap.add_argument("--algo-rounds", type=int, default=5)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    why = frontend_refusal(cfg, "launch/serve.py")
    if why:
        raise SystemExit(why)
    dev = default_device(args.device)
    params, _ = init_lm(cfg, seed=args.seed, device=dev)
    if args.from_algo:
        fed = FedConfig(n_clients=4, s=4, local_steps=2, lr=0.05,
                        quantizer="lattice")
        pool, batch, seq = 8, 2, 32
        data, batch_fn = federated_token_task(args.seed, fed.n_clients,
                                              pool, batch, seq,
                                              cfg.vocab_size, device=dev)
        alg = make_algorithm(args.from_algo, fed,
                             loss_fn=partial(lm_loss, cfg),
                             template=params, batch_fn=batch_fn,
                             batch_size=batch, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        trace = simulate(alg, params, data, gen, rounds=args.algo_rounds,
                         eval_every=0)
        print(f"serving eval_params of a {args.from_algo} run "
              f"({trace.rounds} rounds, "
              f"sim_t={float(trace.final_state.sim_time):.0f})")
        eng = ServeEngine.from_algorithm(cfg, alg, trace.final_state,
                                         max_batch=args.max_batch,
                                         max_seq=128,
                                         temperature=args.temperature)
    else:
        eng = ServeEngine(cfg, params, max_batch=args.max_batch, max_seq=128,
                          temperature=args.temperature)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(1, cfg.vocab_size, plen).tolist()
        eng.submit(Request(prompt=prompt, max_new_tokens=args.max_new))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(gen)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done)
    print(f"{cfg.name} on {dev}: served {len(done)} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s)")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
