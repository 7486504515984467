"""Multi-pod dry run: walk every (architecture × input shape) on the
production mesh abstractly, and dump its cost, memory and roofline terms
(port of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh single --out experiments/dryrun

The reference forces 512 host devices and lowers and compiles each step
with XLA. The port builds the (16, 16) or (2, 16, 16) mesh abstractly
(``launch/mesh.make_production_mesh(abstract=True)``: rank 0's coordinates,
no process group) and runs rank 0's step once on ``meta`` tensors under the
op-cost walker (``launch/hlocost.py``): no memory is allocated and no card
is touched. So ``lower_s`` is that run's seconds and ``compile_s`` is null;
``flop_counter`` (``FlopCounterMode``'s total) takes the place of
``xla_cost_analysis``; ``memory`` holds the rank's blocks of the arguments
(exact, from ``pspec_for``) and of the outputs, the walk's peak of live
storage less the arguments as ``temp_bytes``, and no generated code. An MoE
arch's grouped products (``kernels/grouped_mm.py``) count from their shapes
alone: 2·R·K·N flops and the weights of min(E, R) experts, so any routing
walks alike on ``meta`` and on the card. ``donate`` has no counterpart: a
step returns new blocks and the caller still holds the old ones, so the
peak holds both, as without donation.

The port's steps gather each leaf and run the model whole on every rank
(``launch/steps.py``), where the reference's GSPMD partitions the compute
over 'model': at model=16 the port's ``flops_per_device`` for a train step
is about 16x the reference's and its ``useful_flops_ratio`` about 1/16.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import FedConfig
from repro_torch.launch import roofline as rf
from repro_torch.launch.hlocost import CostWalker
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import (TrainState, build_prefill_step,
                                      build_serve_step, build_train_step,
                                      fed_mode_for, n_slots_for, rank_blocks)
from repro_torch.sharding.rules import cut_block

BF16_SCORES_REFUSAL = (
    "--bf16-scores has no counterpart in the port: it halves the "
    "score-partial all-reduces GSPMD emits for the reference's "
    "tensor-parallel attention, and the port's steps run attention whole "
    "on each rank and reduce no score partials")


def shape_skip_reason(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.long_500k_ok:
        return cfg.long_500k_note or "long_500k skipped for this arch"
    return ""


def pair_config(arch: str, shape_name: str, mesh, moe_impl: str = "",
                mamba_chunk: int = 0):
    """(cfg, shape) of one pair, with the MoE impl, the Mamba chunk and
    the long-context variant applied as the reference's ``lower_pair``
    does."""
    cfg = get_config(arch)
    if moe_impl and cfg.moe is not None:
        from repro_torch.models.moe import set_moe_mesh
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=moe_impl))
        set_moe_mesh(mesh)
    if mamba_chunk and cfg.mamba is not None:
        cfg = cfg.replace(mamba=dataclasses.replace(cfg.mamba,
                                                    chunk=mamba_chunk))
    shape = SHAPES[shape_name]
    if shape.name == "long_500k":
        cfg = cfg.with_long_variant()
    return cfg, shape


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def walk_step(cfg, shape, mesh, fed: FedConfig, *,
              transport: str = "dequant_psum", quantized: bool = True,
              fed_mode: str = None, records: bool = False):
    """Run rank 0's step of (cfg × shape) once on ``meta`` tensors over
    ``mesh`` (an abstract mesh) under a :class:`CostWalker`. Returns
    ``(walker, argument_bytes, output_bytes, seconds, n_slots,
    fed_mode)``."""
    fed_mode = fed_mode or fed_mode_for(cfg.name)
    n_slots = n_slots_for(mesh, fed_mode)
    walker = CostWalker(mesh, records=records)
    coords = mesh.coords()
    t0 = time.perf_counter()
    if shape.kind == "train":
        step, state_spec, (specs, batch_spec) = build_train_step(
            cfg, fed, mesh, shape, fed_mode=fed_mode, transport=transport,
            quantized=quantized, device="meta")
        state = TrainState(
            server=rank_blocks(state_spec.server, specs.server, mesh),
            clients=rank_blocks(state_spec.clients, specs.clients, mesh),
            t=state_spec.t)
        batch = input_specs(cfg, shape, n_slots=n_slots,
                            local_steps=fed.local_steps)
        arg_bytes = walker.track(state) + _nbytes(
            [cut_block(v, batch_spec[k], mesh.shape, coords)
             for k, v in batch.items()])
        with walker:
            out = step(state, batch)
    elif shape.kind == "prefill":
        step, p_spec, (p_specs, b_specs) = build_prefill_step(cfg, mesh,
                                                              shape)
        params = rank_blocks(p_spec, p_specs, mesh)
        batch = rank_blocks(input_specs(cfg, shape), b_specs, mesh)
        arg_bytes = walker.track((params, batch))
        with walker:
            out = step(params, batch)
    else:
        step, p_spec, c_spec, (p_specs, c_specs, t_spec, _) = \
            build_serve_step(cfg, mesh, shape)
        params = rank_blocks(p_spec, p_specs, mesh)
        cache = rank_blocks(c_spec, c_specs, mesh)
        token = cut_block(input_specs(cfg, shape)["token"], t_spec,
                          mesh.shape, coords).clone()
        arg_bytes = walker.track((params, cache, token))
        # the last position of a full cache (int: the step reads it on the
        # host)
        with walker:
            out = step(params, cache, token, shape.seq_len - 1)
    seconds = time.perf_counter() - t0
    return walker, arg_bytes, _nbytes(out), seconds, n_slots, fed_mode


def lower_pair(arch: str, shape_name: str, mesh, fed: FedConfig,
               transport: str = "dequant_psum", quantized: bool = True,
               fed_mode: str = None, donate: bool = True,
               moe_impl: str = "", mamba_chunk: int = 0):
    """Walk one (arch × shape × mesh) abstractly. Returns the result
    dict."""
    cfg, shape = pair_config(arch, shape_name, mesh, moe_impl, mamba_chunk)
    reason = shape_skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    walker, arg_bytes, out_bytes, seconds, n_slots, fed_mode = walk_step(
        cfg, shape, mesh, fed, transport=transport, quantized=quantized,
        fed_mode=fed_mode)
    s = walker.summary()
    coll = s["collectives"]
    flops, bytes_acc = float(s["flops"]), float(s["bytes"])
    terms = rf.roofline(flops, bytes_acc, coll)
    mf = rf.model_flops(cfg, shape, fed.local_steps, n_slots)
    n_dev = int(math.prod(mesh.shape.values()))
    return {
        "arch": arch, "shape": shape_name,
        "mesh": dict(mesh.shape), "n_devices": n_dev,
        "fed_mode": fed_mode if shape.kind == "train" else "-",
        "transport": transport if shape.kind == "train" else "-",
        "quantized": quantized if shape.kind == "train" else "-",
        "flops_per_device": flops, "bytes_per_device": bytes_acc,
        "flop_counter": {"flops": s["flop_counter"],
                         "gemm_flops": s["gemm_flops"],
                         "kernel_flops": s["kernel_flops"]},
        "collectives": coll,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": s["peak_live_bytes"] - arg_bytes,
                   "generated_code_bytes": None},
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / flops if flops else None,
        "kernels": s["kernels"],
        "lower_s": seconds, "compile_s": None,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--transport", default="dequant_psum")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--fed-mode", default=None)
    ap.add_argument("--moe-impl", default="")
    ap.add_argument("--bf16-scores", action="store_true")
    ap.add_argument("--mamba-chunk", type=int, default=0)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if args.bf16_scores:
        ap.error(BF16_SCORES_REFUSAL)
    return args


def run_pair(arch: str, shape: str, args) -> str:
    """Walk one pair as ``main`` asks, write its JSON under ``args.out``
    and return its ``[OK]``/``[SKIP]``/``[FAIL]`` line."""
    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                abstract=True)
    fed = FedConfig(bits=args.bits, local_steps=args.local_steps)
    tag = f"{arch}__{shape}__{args.mesh}" + (
        f"__{args.tag}" if args.tag else "")
    path = os.path.join(args.out, tag + ".json")
    try:
        res = lower_pair(arch, shape, mesh, fed,
                         transport=args.transport,
                         quantized=not args.no_quant,
                         fed_mode=args.fed_mode,
                         moe_impl=args.moe_impl,
                         mamba_chunk=args.mamba_chunk)
    except Exception as e:
        res = {"arch": arch, "shape": shape, "mesh": args.mesh,
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    if "error" in res:
        return f"[FAIL] {tag}: {res['error']}"
    if "skipped" in res:
        return f"[SKIP] {tag}: {res['skipped']}"
    r = res["roofline"]
    return (f"[OK]   {tag}: flops/dev={res['flops_per_device']:.3e} "
            f"compute={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
            f"coll={r['collective_s']:.4f}s dom={r['bottleneck']} "
            f"(lower {res['lower_s']:.1f}s)")


def main(argv=None):
    args = parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]
    os.makedirs(args.out, exist_ok=True)
    jobs = min(len(pairs), len(os.sched_getaffinity(0)))
    if jobs == 1:
        for arch, shape in pairs:
            print(run_pair(arch, shape, args), flush=True)
        return
    # the pairs over as many processes as this process may use cores, the
    # lines in the pairs' order
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        futures = [pool.submit(run_pair, a, s, args) for a, s in pairs]
        for fut in futures:
            print(fut.result(), flush=True)


if __name__ == "__main__":
    main()
