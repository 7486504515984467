"""Serving driver: batched requests against a dense LM through the
ServeEngine (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --device cpu

It runs on the card unless ``--device cpu`` asks for the CPU. Weights are a
fresh init from ``--seed`` (``--full``: the architecture's published
widths; else its reduced member). ``--from-algo`` (serve the eval_params of
a federated LM run) needs LM training through a federated algorithm, which
is not ported yet (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.models.model import init_lm
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
                         "(not ported yet)")
    args = ap.parse_args(argv)

    if args.from_algo:
        raise NotImplementedError(
            "--from-algo trains the LM through a federated algorithm (lm_loss "
            "and autograd, with a backward for the attention path): not "
            "ported yet (ROADMAP Queue 1 item 12)")
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    dev = default_device(args.device)
    params, _ = init_lm(cfg, seed=args.seed, device=dev)
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
