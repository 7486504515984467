"""End-to-end training (twin of ``examples/train_e2e.py``): the mesh QuAFL
train step on a ~100M-parameter LLaMA-family model for a few hundred rounds
on synthetic non-iid token streams, with the quantized client/server
exchange.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --tiny \\
        --steps 20 --device cpu

It drives :func:`repro_torch.launch.steps.build_train_step` directly on the
(1, 1) mesh, as the reference's script does (one client slot: the mesh's
data axis), and runs on the card unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import default_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import FedConfig, LayerSpec, ShapeConfig
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (build_train_step, init_train_state,
                                      shard_train_state)
from repro_torch.models.model import lm_loss


def model_100m():
    """llama3.2-family member scaled to ~100M params."""
    return get_config("llama3.2-1b").replace(
        n_layers=4, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32_000,
        schedule=(LayerSpec(),),
        param_dtype="float32", dtype="float32")


def model_tiny():
    return get_config("llama3.2-1b").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=1024, schedule=(LayerSpec(),),
        param_dtype="float32", dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--n-slots", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path; the card when "
                         "omitted")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    cfg = model_tiny() if args.tiny else model_100m()
    fed = FedConfig(n_clients=args.n_slots, s=args.n_slots,
                    local_steps=args.local_steps, lr=args.lr, bits=args.bits)
    shape = ShapeConfig("e2e", args.seq, args.batch * args.n_slots, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    step, _, (specs, _) = build_train_step(cfg, fed, mesh, shape,
                                           fed_mode="client_dp", device=dev)
    full = init_train_state(cfg, 0, step.n_slots, device=dev)
    state = shard_train_state(full.server, full.clients, full.t, mesh, specs)
    del full
    n_params = sum(int(v.numel()) for v in state.server.values())
    print(f"model: {cfg.name}-100m  params={n_params/1e6:.1f}M  "
          f"slots={step.n_slots} K={args.local_steps} bits={args.bits}",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    eval_toks = lm_token_stream(gen, args.batch, args.seq, cfg.vocab_size)
    gen.manual_seed(0)
    t0 = time.time()
    for r in range(args.steps):
        toks = torch.stack([torch.stack([lm_token_stream(
            gen, args.batch, args.seq, cfg.vocab_size, client_id=i)
            for _ in range(args.local_steps)])
            for i in range(step.n_slots)])
        state, m = step(state, {"tokens": toks}, gen)
        if (r + 1) % max(args.steps // 10, 1) == 0 or r == 0:
            with torch.no_grad():
                loss, _ = lm_loss(cfg, step.server_leaves(state),
                                  {"tokens": eval_toks})
            print(f"round {r+1:4d}/{args.steps} "
                  f"server_loss={float(loss):.4f} "
                  f"h={float(m['h_steps_mean']):.1f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, args.steps,
                        step.server_leaves(state))
        print("checkpoint:", args.checkpoint_dir)
    return state


if __name__ == "__main__":
    main()
