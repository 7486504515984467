"""Serving example (twin of ``examples/serve_requests.py``): batched
request serving of a model from the zoo through the prefill +
single-token-decode path.

    PYTHONPATH=src python -m repro_torch.examples.serve_requests \\
        --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.examples.serve_requests \\
        --arch mamba2-370m --device cpu

The reduced member of ``--arch``, random weights from seed 0, ten requests
of 4-31 prompt tokens (numpy seed 0), 16 new tokens each, sampled at
temperature 0.7 (a generator seeded 1), four requests a batch and a
96-deep cache, as the reference's script. It runs on the card unless
``--device cpu`` asks for the CPU. Encoder-decoder archs are refused, as
the reference refuses them; so are frontend archs, which the reference's
engine cannot serve either (its prompts carry no frontend embeddings).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs import get_reduced, list_archs
from repro_torch.models.model import frontend_refusal, init_lm
from repro_torch.serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    choices=list_archs())
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card when "
                         "omitted")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    why = frontend_refusal(cfg, "this demo")
    if why:
        raise SystemExit(why)
    dev = default_device(args.device)
    params, _ = init_lm(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=4, max_seq=96, temperature=0.7)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 32))
        eng.submit(Request(prompt=rng.integers(1, cfg.vocab_size,
                                               plen).tolist(),
                           max_new_tokens=args.max_new))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    t0 = time.time()
    done = eng.run(gen)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    tok = sum(len(r.out_tokens) for r in done)
    print(f"{args.arch} (reduced): {len(done)} requests, {tok} tokens "
          f"in {dt:.2f}s -> {tok/dt:.1f} tok/s")
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: {len(r.prompt)}-token prompt -> {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
