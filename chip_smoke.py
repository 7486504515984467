#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout: builds the CUDA kernels of
``src/repro_torch/kernels/csrc/`` with nvcc (one compiler per source, all
started together), holds each kernel against its plain PyTorch version on
the card and times both (the exchange's cluster kernels, ``fused_rotate``,
``fused_encode`` and ``fused_decode``, and ``quantize_codes`` and
``snap_codes`` also with their profiled device time a launch at the paths'
shapes and their grid; the encode and decode with their mismatch counts),
then drives the port's paths:

* the kernels' public API (``kernels/ops.py``) as a user calls it:
  ``rotate_blocks``, ``lattice_encode``, ``lattice_decode`` and the inverse
  rotation on flat vectors of 2^25, 10,000,000 and 25,450 coordinates (the
  exchange bench size, ``bench_kernels.py``'s ``rotate_10M`` and the
  paper's MLP), every rotation equal to the exchange's ``fused_rotate``,
  every decode within 1.001 γ;
* QuAFL (paper Algorithm 1) at the paper's MLP width (784-32-10, n=300
  clients, s=16) through ``make_algorithm`` and ``simulate``, once with the
  8-bit ``lattice`` codec and once with a ``lattice_packed:bits=4`` uplink;
* the paper's baselines through ``compare`` at the same width: FedAvg,
  compressed FedAvg (lattice, scalar and ``topk_ef`` uplinks), FedBuff
  (lattice and qsgd deltas, a ``topk_ef`` uplink) and the sequential node,
  30 rounds each; on one ``topk_ef`` round the error-feedback invariant
  bit for bit on the card, ties included;
* QuAFL's other paths at the same width, 30 rounds each: the grouped
  per-client uplink (fast clients at b=8, the slow 30% charged b=4, a
  per-message levels row through the encode and the snap), the
  ``cyclic`` and ``gamma_straggler`` participation specs, and the
  per-message branch (a ``scalar`` uplink, the lattice downlink through the
  codec API); every round's bits exact from its sampled ids;
* the extensions at the same width, 30 rounds each: ``quafl_scaffold``
  (three encodes and three decodes a round through the codec API, the
  controls decoded against 16 distinct references; one round on the
  kernels against the plain versions) and ``adaptive_quafl`` from b=12
  (the pipeline at each visited width; the width trace against the walk
  of the emitted ``quant_err``);
* the quickstart: its four runs (``quafl``, ``quafl_het``, ``fedavg``,
  ``fedpaq``) through ``compare`` at the same width and an equal simulated
  time, then ``python -m repro_torch.examples.quickstart``,
  ``...heterogeneous_clients`` and ``...scaffold_noniid`` as a user runs
  them, each in a subprocess;
* the round engine at the same width, 30 rounds: ``quafl`` (b=8 and a
  ``lattice_packed:bits=4`` uplink), ``compressed_fedavg``,
  ``fedbuff_device`` (Z=10, the seed bridge's table from the run's seed),
  ``quafl_scaffold``, ``fedavg``, ``sequential`` and ``adaptive_quafl``
  from b=12, each through ``compare`` eager and in chunks of 10 rounds
  (and ``scan_chunk="auto"``) captured as CUDA graphs and replayed, in
  three alternating repeats: bits and sim_time exact every round, the
  server within the reference's lattice-chunk tolerance, the same port
  kernels a round (from the profiler's device events), ms per round of
  each; then ``fedbuff_device`` against ``fedbuff``, pop for pop;
* federated LM training through ``python -m repro_torch.launch.train``'s
  ``run_registry``: llama3.2-1b at full width (1,235,814,400 parameters,
  random weights from seed 0), five QuAFL rounds at b=8, n = s = 2, batch 8
  of 128 tokens, in a process of its own: bits exact every round, the
  peak memory, ms and device ms a round, one profiled round's launches
  (1 encode, 3 rotations, 1 quantize, the fused uplink and average) and
  their device ms at this shape beside their byte bounds, and each launch
  of a further round held against its plain version on its first 2^24
  coordinates; with the model freed, the fused uplink and average at the
  full (2, d_pad) against their plain versions (the averages bit for bit,
  rel_err and hint_srv within 1e-5 relative); then every registry algorithm two rounds at reduced width,
  a ``--scan-chunk 2`` run against its eager run, and a checkpoint saved
  and restored;
* the mesh train step (``--algo spmd``, ``launch/train.py``'s default),
  in a process of its own over an NCCL process group of one rank (an
  in-memory store): llama3.2-1b at full width, five rounds of the default
  ``dequant_psum`` transport (bits exact every round, 9,886,515,552 each
  way; 2 encodes and 2 decodes a leaf), the peak memory, ms and device ms a
  round and NCCL's kernels, then one ``shard_local`` round (2 encodes, 3
  rotations, 2 snaps a leaf); at reduced width each of the five transports
  on the local (1, 1) mesh and on the NCCL group, bit-equal, and
  ``simulate(scan_chunk=2)`` bit-equal to eager with the collectives
  captured; ``scatter_encode_gather`` at embed/tok's padded length in 4
  shards, the quantize and the snap exact against their plain versions;
* LM serving of gemma2-2b at full width (26 layers, random weights from
  seed 0) through ``ServeEngine``: two batches of four prompts (longest 512
  and 4,608 tokens), 32 greedy tokens each, twice, then one batch sampled
  at temperature 0.8; every prefill attention on the bf16 tensor-core
  flash-attention kernel (``csrc/flash_wgmma.cu``). Then a prefill/decode
  consistency check in fp32 (the CUDA-core flash kernel) and bf16, and the
  serve CLI (``repro_torch.launch.serve --full``) once;
* the rest of the decoder zoo, in a process of its own (``--zoo``):
  mamba2-370m at full width (368,338,432 parameters) through five QuAFL
  rounds and five ``--algo spmd`` rounds as above (bits exact, every
  launch of a further round held on a 2^24 prefix); then served through
  ``ServeEngine``, greedy twice with identical tokens, with the fp32
  prefill/decode check: mamba2 (batches A and B), gemma3-12b whole (48
  flash launches a prefill), deepseek-v2-236b cut to 2 layers (the MLA
  prefix layer and one MLA-MoE layer, top-6 of 160 experts), llama4-scout
  cut to 4 layers (one iRoPE period; its global NoPE layer on the flash
  kernel at a GQA group of 5) and reduced jamba-1.5-large; then two QuAFL
  rounds of reduced jamba. The flash kernel is held against its plain
  version at the zoo's shapes with the other flash checks.
* the population store split across ranks and the mesh serving steps,
  in a process of its own (``--population``) over an NCCL group of one:
  QuAFL at the paper's cell (n=300, s=16, 30 rounds in captured 10-round
  chunks) on a store split over ``client_mesh()`` against the whole
  store (bits exact every round, servers and every row bit-equal), one
  round each of ``quafl_scaffold``, ``compressed_fedavg`` and
  ``fedbuff_device`` the same way; the split-store QuAFL at n = 10^3 and
  10^5 (s=8; 10.2 GB of client models) in captured chunks, ms a round at
  10^5 within 1.5x of 10^3; gemma2-2b at full width on batch A through
  ``build_prefill_step`` (26 flash launches) and 32 ``build_serve_step``
  calls, greedy tokens identical to ``ServeEngine``'s.
* the encoder-decoder and frontend archs, in a process of its own
  (``--encdec``) over an NCCL group of one: seamless-m4t-medium whole
  (977,758,208 parameters; 12 encoder and 12 decoder layers) and
  llava-next-34b cut to 4 of its 60 layers, each through
  ``build_prefill_step`` (text tokens beside stub frame embeddings, or
  after 2,880 stub patch embeddings) and 16 greedy ``build_serve_step``
  calls, twice and identical, one flash launch a decoder layer, with the
  fp32 prefill/decode check; then one QuAFL round of seamless at b=8
  through ``build_train_step`` with frontend batches (bits exact per
  leaf, 2 encodes and 2 decodes a leaf) and one ``shard_local`` round,
  every launch held against its plain version on a 2^24 prefix.
* the dry-run tools, in a process of its own (``--tools``) over an NCCL
  group of one: ``launch/dryrun.py`` for all 40 arch × shape pairs and one
  ``--mesh multi`` pair as subprocesses on the host (every record [OK] or
  the reference's [SKIP] note); four steps that fit the card (gemma2-2b's
  prefill at 4 × 4,096 and serve step at 4,096, llama3.2-1b's
  ``dequant_psum`` round, llama4-scout's prefill at 4 of 48 layers with
  ``ragged_shmap``) counted abstractly and under the same walker on their
  real runs (flops equal, bytes within 1%), their bound over their device
  ms at most 1.05; llama4-scout through the mesh prefill and 16 serve
  steps with ``ragged_shmap`` and ``ragged`` (tokens identical, fp32
  logits within atol 2e-4, rtol 2e-3); the rotation budget of QuAFL at
  n=300, s=16 and each transport's collective bytes against its caps.
* the invariant gate, in a process of its own (``--analysis``) over an
  NCCL group of one: ``python -m repro_torch.analysis.lint``'s whole
  matrix on the card (25 algorithm × codec cells, 9 codec × transport
  exchanges, rs_transport, 8 sentinel runs) with every captured round
  under ``torch.cuda.set_sync_debug_mode("error")``, 0 violations; the
  exchanges also on real tensors over the group, replicated outputs equal
  across ranks; then a 10-round QuAFL chunk's captured graph read back
  (``lowered_chunk``), its kernel nodes equal to a replay's launches.
* the MoE's grouped product (``kernels/grouped_mm.py``), in a process of
  its own (``--moe``): its three kernels (on wgmma in bf16: forward and
  dgrad ``grouped_{fwd,dgrad}_wgmma_kernel`` with their ordered sum of a
  split K, wgrad ``grouped_wgrad_wgmma_kernel`` in persistent CTAs; on
  FMAs in fp32) against their plain
  versions in fp32 and bf16 at deepseek-v2's and llama4-scout's published
  expert shapes (the gate's and up's, d_model to d_ff_expert, and the down
  projection's, back), routed by each arch's router for batch A's prefill
  and a decode step, and at edge cases, each timed beside its bound, the
  plain loop, ``torch._grouped_mm`` on bf16 weights and the reference's
  own work (the cast of the weights, then that call), with the bf16
  kernels' launch geometry and registers (``grouped_check``); one
  deepseek-v2 MoE layer at published widths forward and backward, eager
  and captured in a CUDA graph, ``torch.equal`` (``moe_layer_full``);
  reduced deepseek-v2, llama4-scout and jamba-1.5 through ``--scan-chunk
  2`` and deepseek-v2's ``--algo spmd`` chunks, every captured round
  under the sync-debug mode, equal to eager (``moe_chunks``). The zoo's
  MoE serving runs the same forward kernel.

Each path runs with the launch counts set to 0 just before it and read just
after. It prints JSON lines per phase, a ``kernels`` line, the card's name
and power limit, and last ``{"ok": true, "device": ...}``.

Every check raises on failure, so any failed phase exits non-zero; so does a
machine without CUDA. The port imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

CSRC = "src/repro_torch/kernels/csrc/"
REPLACES = {
    "fused_encode": "src/repro/kernels/exchange.py:322",
    "fused_rotate": "src/repro/kernels/exchange.py:266",
    "quantize_codes": "src/repro/kernels/exchange.py:371",
    "snap_codes": "src/repro/kernels/exchange.py:417",
    "fused_decode": "src/repro/kernels/exchange.py:464",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "hadamard_blocks": "src/repro/kernels/hadamard.py:31",
    "lattice_encode": "src/repro/kernels/lattice_quant.py:47",
    "lattice_decode": "src/repro/kernels/lattice_quant.py:69",
}
SOURCES = {k: CSRC + "exchange.cu" for k in REPLACES} | {
    "flash_attention": CSRC + "flash_wgmma.cu",    # bf16, the serve path
    "hadamard_blocks": CSRC + "hadamard.cu",
    "lattice_encode": CSRC + "lattice_quant.cu",
    "lattice_decode": CSRC + "lattice_quant.cu"}
# fp32 operations per coordinate, for the operation bound: the butterfly's
# log2(b) adds plus the sign and scale multiplies; the quantize's div, add,
# floor, div, floor, mul and sub; the snap's div, sub, div, rint, mul, add
# and mul. Every kernel here is far below the card's ops/byte ridge.
QUANTIZE_OPS, SNAP_OPS = 7, 7
# device-memory rate by card name (NVIDIA data sheets); H100 SXM otherwise
PEAK_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                    ("H200", 4.8e12), ("H100", 3.35e12))
PEAK_FP32_OPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12      # H100 SXM, bf16 dense on the tensor cores

BENCH_M, BENCH_D = 32, 1 << 20    # benchmarks/bench_exchange.py's D_FULL
N_CLIENTS, S, K, LR, SWT, ROUNDS = 300, 16, 5, 0.3, 10.0, 30
SEED = 0                          # data, weights and draws of the main path
ROT_TOL = 1e-5                    # rotation: max err / max|y|
ENC_MISMATCH_FRAC = 1e-4          # encode: ±1 mod L on at most this share
DECODE_TOL = 1e-6                 # decode: max err / max|x| (target 0)
D_MLP = 25_450                    # 784-32-10: d_pad 32,768
BITS_DOWN = 262_176               # the downlink Enc(X_t) at b=8, d_pad 32,768
# the grouped uplink: fast clients at b=8 (262,208 bits a message with γ and
# the levels entry), the slow 30% (ids 0-89 of 300) charged b=4 packed
# (131,136); the codes ride unpacked at modulus 256 or 16
GROUPED = {"fast": "lattice", "slow": "lattice_packed:bits=4"}
FAST_BITS, SLOW_BITS, N_SLOW = 32_768 * 8 + 64, 32_768 * 4 + 64, 90
GROUPED_LEVELS = [256.0] * 11 + [16.0] * 5
CYCLIC = "cyclic:period=8,phase_groups=4"      # group (t // 2) % 4 of 75
GAMMA = "gamma_straggler:strength=1"
TOPK, TOPK_BITS = "topk_ef:frac=0.01", 254 * 64   # k = round(0.01 · 25,450)
# quafl_scaffold at b=8: 2 messages up per sampled client, 2 down
SCAFFOLD_UP, SCAFFOLD_DOWN = 2 * S * BITS_DOWN, 2 * BITS_DOWN
# adaptive_quafl: from b=12 in the band [0.01, 0.05], b in [4, 16]
ADAPTIVE = dict(lo=0.01, hi=0.05, b_min=4, b_max=16)
ADAPTIVE_BITS0 = 12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peak_bytes_per_s(name: str) -> float:
    return next(v for k, v in PEAK_BYTES_PER_S if k in name)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, symbol: str, iters: int = 20, tries: int = 3):
    """Mean device ms a launch of the kernel whose symbol holds ``symbol``,
    from torch.profiler over ``iters`` calls of ``fn`` after a warm-up;
    profiled again (up to ``tries`` times) when the trace holds no launch
    of it, as the profiler now and then returns no kernel events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = ms_per_launch(device_events(prof), {"k": symbol})["k"]
        if ms is not None:
            return ms
    return None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, ops: float, peak_bw: float,
          ops_rate: float = PEAK_FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the rate of their type (fp32 unless given)."""
    t_bytes = bytes_moved / peak_bw * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def code_gap(a, b, levels) -> torch.Tensor:
    diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return torch.minimum(diff, levels - diff)


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version on the card
# ---------------------------------------------------------------------------

def kernel_cases(kx, dev, gen, m, d_pad, bits, pack, levels=None):
    """Run the four kernels and their plain versions on one shape; return
    the error figures and the inputs of each call, for timing."""
    from repro_torch.compression.rotation import signs
    x = torch.randn((m, d_pad), generator=gen, device=dev)
    sg = signs(gen, d_pad)
    u = torch.rand((m, d_pad), generator=gen, device=dev)
    y_plain = kx.rotate_plain(x, sg)
    L = float(1 << bits)
    lv = None
    if levels is not None:
        lv = torch.tensor(levels, dtype=torch.float32, device=dev)
        L_col = lv[:, None]
    else:
        L_col = torch.full((m, 1), L, device=dev)
    # scales at which y/γ spans the ring a few times: codes wrap
    gam = (y_plain.abs().amax(dim=1) / L_col[:, 0] / 2).contiguous()
    res = {"m": m, "d_pad": d_pad, "bits": bits, "pack": pack,
           "levels": levels is not None,
           "encode_launch": kx.launch_geometry(m, d_pad, pack=pack)}

    # rotation, both directions
    rot_err = 0.0
    for inverse in (False, True):
        yk = kx.fused_rotate(x, sg, inverse=inverse)
        yp = kx.rotate_plain(x, sg, inverse=inverse)
        rot_err = max(rot_err, float((yk - yp).abs().max()
                                     / yp.abs().max()))
    res["rotate_rel_err"] = rot_err
    assert rot_err == 0.0, res     # the same stages in the same order

    # fused encode vs plain encode
    kw = dict(bits=bits, pack=pack, levels2=lv)
    yk, ck = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
    yp, cp = kx.encode_plain(x, sg, u, gam, want_rotated=True, **kw)
    unpack = ((lambda c: kx.unpack_codes(c, bits=bits)) if pack > 1
              else (lambda c: c))
    gap = code_gap(unpack(ck), unpack(cp), L_col.to(torch.int64))
    res["encode_mismatches"] = int((gap > 0).sum())
    res["encode_max_gap"] = int(gap.max())
    res["encode_y_rel_err"] = float((yk - yp).abs().max() / yp.abs().max())
    assert res["encode_max_gap"] <= 1, res
    assert res["encode_mismatches"] <= ENC_MISMATCH_FRAC * m * d_pad, res
    assert res["encode_y_rel_err"] <= ROT_TOL, res

    # quantize: exact against the plain version and against the fused
    # encode's codes on the same y
    qk = kx.quantize_codes(yk, u, gam, **kw)
    qp = kx.quantize_plain(yk, u, gam, **kw)
    res["quantize_mismatches"] = int((qk != qp).sum())
    res["quantize_max_gap"] = int(code_gap(unpack(qk), unpack(qp),
                                           L_col.to(torch.int64)).max())
    res["quantize_vs_encode_mismatches"] = int((qk != ck).sum())
    assert res["quantize_mismatches"] == 0, res
    assert res["quantize_vs_encode_mismatches"] == 0, res

    # snap, broadcast both ways: m codes vs one reference (uplink decode)
    # and one code row vs m references (downlink decode)
    w = yk + 0.25 * gam[:, None] * torch.randn((m, d_pad), generator=gen,
                                               device=dev)
    snap_err = 0.0
    cases = [(ck, w[:1].contiguous(), gam, lv),
             (ck[:1].contiguous(), w, gam[:1].contiguous(),
              None if lv is None else lv[:1].contiguous())]
    for codes, ref, g, lv_ in cases:
        sk = kx.snap_codes(codes, ref, g, bits=bits, pack=pack, levels2=lv_)
        sp = kx.snap_plain(codes, ref, g, bits=bits, pack=pack, levels2=lv_)
        snap_err = max(snap_err, float((sk - sp).abs().max()))
    res["snap_max_abs_err"] = snap_err
    assert snap_err == 0.0, res
    torch.cuda.synchronize()
    return res, dict(x=x, sg=sg, u=u, gam=gam, y=yk, codes=ck, w=w, kw=kw)


def time_kernels(kx, io, m, d_pad, bits, pack, peak_bw):
    """ms, plain_ms, bound_ms, bound_by and library_ms of each kernel."""
    x, sg, u, gam, y = io["x"], io["sg"], io["u"], io["gam"], io["y"]
    codes, w, kw = io["codes"], io["w"], io["kw"]
    b = min(d_pad, 16_384)
    log_b = int(math.log2(b))
    n = m * d_pad
    x1, u1, g1 = x[:1].contiguous(), u[:1].contiguous(), gam[:1].contiguous()
    out = {}

    # fused_rotate: the inverse rotation of the s new client states, and
    # (fused_rotate_1) the server's forward rotation, one message
    rb, rby = bound(nbytes(x, sg) + nbytes(x), n * (log_b + 2), peak_bw)
    from repro_torch.compression.rotation import _factor, hadamard_matrix
    r, c = _factor(b)
    hr = torch.from_numpy(hadamard_matrix(r)).to(x.device)
    hc = torch.from_numpy(hadamard_matrix(c)).to(x.device)
    xb = x.view(n // b, r, c)
    torch.backends.cuda.matmul.allow_tf32 = False
    out["fused_rotate"] = dict(
        ms=time_ms(lambda: kx.fused_rotate(x, sg, inverse=True)),
        plain_ms=time_ms(lambda: kx.rotate_plain(x, sg, inverse=True)),
        bound_ms=rb, bound_by=rby,
        library_ms=time_ms(lambda: torch.einsum("ij,bjk,kl->bil", hr, xb,
                                                hc)),
        shape=[m, d_pad], launch=kx.launch_geometry(m, d_pad),
        kernel_device_ms=kernel_device_ms(
            lambda: kx.fused_rotate(x, sg, inverse=True),
            KERNEL_SYMBOLS["fused_rotate"]))
    r1b, r1by = bound(nbytes(x1, sg) + nbytes(x1), d_pad * (log_b + 2),
                      peak_bw)
    out["fused_rotate_1"] = dict(
        ms=time_ms(lambda: kx.fused_rotate(x1, sg)),
        plain_ms=time_ms(lambda: kx.rotate_plain(x1, sg)),
        bound_ms=r1b, bound_by=r1by,
        library_ms=time_ms(lambda: torch.einsum("ij,bjk,kl->bil", hr,
                                                xb[:d_pad // b], hc)),
        shape=[1, d_pad], launch=kx.launch_geometry(1, d_pad),
        kernel_device_ms=kernel_device_ms(lambda: kx.fused_rotate(x1, sg),
                                          KERNEL_SYMBOLS["fused_rotate"]))

    # fused_encode with y kept: the uplink of the s sampled clients
    eb, eby = bound(nbytes(x, sg, u, gam) + nbytes(y, codes),
                    n * (log_b + 2 + QUANTIZE_OPS), peak_bw)
    out["fused_encode"] = dict(
        ms=time_ms(lambda: kx.fused_encode(x, sg, u, gam, want_rotated=True,
                                           **kw)),
        plain_ms=time_ms(lambda: kx.encode_plain(x, sg, u, gam,
                                                 want_rotated=True, **kw)),
        bound_ms=eb, bound_by=eby, library_ms=None, shape=[m, d_pad],
        launch=kx.launch_geometry(m, d_pad, pack=pack),
        kernel_device_ms=kernel_device_ms(
            lambda: kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw),
            KERNEL_SYMBOLS["fused_encode"]))

    # fused_encode of one message with its own sign row, no y: a baseline's
    # uplink (FedBuff's delta)
    s1 = sg[None].contiguous()
    c1 = kx.fused_encode(x1, s1, u1, g1, **kw)
    e1b, e1by = bound(nbytes(x1, s1, u1, g1) + nbytes(c1),
                      d_pad * (log_b + 2 + QUANTIZE_OPS), peak_bw)
    out["fused_encode_1"] = dict(
        ms=time_ms(lambda: kx.fused_encode(x1, s1, u1, g1, **kw)),
        plain_ms=time_ms(lambda: kx.encode_plain(x1, s1, u1, g1, **kw)),
        bound_ms=e1b, bound_by=e1by, library_ms=None, shape=[1, d_pad],
        launch=kx.launch_geometry(1, d_pad, pack=pack),
        kernel_device_ms=kernel_device_ms(
            lambda: kx.fused_encode(x1, s1, u1, g1, **kw),
            KERNEL_SYMBOLS["fused_encode"]))

    # quantize_codes: the downlink Enc(X_t), one message
    y1 = y[:1].contiguous()
    c1 = kx.quantize_codes(y1, u1, g1, bits=bits, pack=pack)
    qb, qby = bound(nbytes(y1, u1, g1) + nbytes(c1), d_pad * QUANTIZE_OPS,
                    peak_bw)
    out["quantize_codes"] = dict(
        ms=time_ms(lambda: kx.quantize_codes(y1, u1, g1, bits=bits,
                                             pack=pack)),
        plain_ms=time_ms(lambda: kx.quantize_plain(y1, u1, g1, bits=bits,
                                                   pack=pack)),
        bound_ms=qb, bound_by=qby, library_ms=None, shape=[1, d_pad],
        launch=kx.quantize_geometry(1, d_pad, pack=pack),
        kernel_device_ms=kernel_device_ms(
            lambda: kx.quantize_codes(y1, u1, g1, bits=bits, pack=pack),
            KERNEL_SYMBOLS["quantize_codes"]))

    # snap_codes: the uplink decode, m codes against the one rotated server,
    # and (snap_codes_down) the downlink decode, the server's one code row
    # against the m rotated clients
    w1, cd1 = w[:1].contiguous(), codes[:1].contiguous()
    for key, args in (("snap_codes", (codes, w1, gam)),
                      ("snap_codes_down", (cd1, w, g1))):
        s_out = kx.snap_codes(*args, bits=bits, pack=pack)
        sb, sby = bound(nbytes(*args) + nbytes(s_out), n * SNAP_OPS, peak_bw)
        out[key] = dict(
            ms=time_ms(lambda a=args: kx.snap_codes(*a, bits=bits,
                                                    pack=pack)),
            plain_ms=time_ms(lambda a=args: kx.snap_plain(*a, bits=bits,
                                                          pack=pack)),
            bound_ms=sb, bound_by=sby, library_ms=None, shape=[m, d_pad],
            code_rows=int(args[0].shape[0]), ref_rows=int(args[1].shape[0]),
            launch=kx.snap_geometry(m, d_pad),
            kernel_device_ms=kernel_device_ms(
                lambda a=args: kx.snap_codes(*a, bits=bits, pack=pack),
                KERNEL_SYMBOLS["snap_codes"]))
    return out


def decode_case(kx, dev, gen, m, d_pad, bits, pack, *, mr=1, sign_rows=False,
                levels=None):
    """fused_decode against decode_plain on one shape: m code rows (from
    encoding x, whose rows lie close together) against mr references x +
    a perturbation inside the wrap window; one shared sign row or m rows."""
    from repro_torch.compression.rotation import signs
    x = (torch.randn((1, d_pad), generator=gen, device=dev)
         + 0.05 * torch.randn((m, d_pad), generator=gen, device=dev))
    sg = (signs(gen, m * d_pad).reshape(m, d_pad) if sign_rows
          else signs(gen, d_pad))
    u = torch.rand((m, d_pad), generator=gen, device=dev)
    lv = (None if levels is None
          else torch.tensor(levels, dtype=torch.float32, device=dev))
    L = lv if lv is not None else torch.full((m,), float(1 << bits),
                                               device=dev)
    gam = (kx.rotate_plain(x, sg).abs().amax(dim=1) / L / 2).contiguous()
    kw = dict(bits=bits, pack=pack, levels2=lv)
    codes = kx.fused_encode(x, sg, u, gam, **kw)
    ref = (x[:mr] + 0.1 * gam[:mr, None]
           * torch.randn((mr, d_pad), generator=gen, device=dev))
    out = kx.fused_decode(codes, ref, sg, gam, **kw)
    want = kx.decode_plain(codes, ref, sg, gam, **kw)
    err = float((out - want).abs().max())
    res = {"m": m, "mr": mr, "d_pad": d_pad, "bits": bits, "pack": pack,
           "sign_rows": sign_rows, "levels": levels is not None,
           "launch": kx.launch_geometry(m, d_pad, pack=pack),
           "decode_mismatches": int((out != want).sum()),
           "decode_max_abs_err": err,
           "decode_rel_err": err / float(x.abs().max()),
           "decode_vs_x_max": float((out - x).abs().max()),
           "gamma_max": float(gam.max())}
    if sign_rows:
        # fused_encode with per-message sign rows against encode_plain
        codes_p = kx.encode_plain(x, sg, u, gam, **kw)
        res["encode_sign_rows_mismatches"] = int((codes != codes_p).sum())
        assert res["encode_sign_rows_mismatches"] == 0, res
    assert res["decode_rel_err"] <= DECODE_TOL, res
    torch.cuda.synchronize()
    return res, dict(codes=codes, ref=ref, sg=sg, gam=gam, kw=kw)


def time_decode(kx, io, peak_bw):
    """ms, plain_ms, bound_ms, bound_by and library_ms of fused_decode."""
    codes, ref, sg, gam, kw = (io["codes"], io["ref"], io["sg"], io["gam"],
                               io["kw"])
    out = kx.fused_decode(codes, ref, sg, gam, **kw)
    m, d_pad = out.shape
    log_b = int(math.log2(min(d_pad, 16_384)))
    # two butterflies, two sign and two scale multiplies, the snap
    db, dby = bound(nbytes(codes, ref, sg, gam) + nbytes(out),
                    m * d_pad * (2 * log_b + 4 + SNAP_OPS), peak_bw)
    return dict(ms=time_ms(lambda: kx.fused_decode(codes, ref, sg, gam,
                                                   **kw)),
                kernel_device_ms=kernel_device_ms(
                    lambda: kx.fused_decode(codes, ref, sg, gam, **kw),
                    KERNEL_SYMBOLS["fused_decode"]),
                plain_ms=time_ms(lambda: kx.decode_plain(codes, ref, sg, gam,
                                                         **kw)),
                bound_ms=db, bound_by=dby, library_ms=None,
                shape=[m, d_pad], ref_rows=int(ref.shape[0]),
                sign_rows=int(sg.dim() == 2),
                launch=kx.launch_geometry(m, d_pad, pack=kw["pack"]))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

class SampleLog:
    """A participation spec that records the client ids of every round."""

    def __init__(self, part):
        self.part = part
        self.ids = []

    def __getattr__(self, name):
        return getattr(self.part, name)

    def sample(self, *args, **kw):
        idx = self.part.sample(*args, **kw)
        self.ids.append(idx)
        return idx


def grouped_bits_up(ids) -> int:
    """A grouped round's uplink bits from its sampled ids."""
    ids = ids.cpu()
    n_slow = int((ids < N_SLOW).sum())
    return n_slow * SLOW_BITS + (len(ids) - n_slow) * FAST_BITS


def chip_world(dev):
    """The paths' FedConfig, data, test set, initial params and generator
    (784-32-10, n=300, seed 0)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_mlp import dims
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.models.mlp import init_mlp_classifier
    d_in, d_hidden, n_cls = dims()
    fed = FedConfig(n_clients=N_CLIENTS, s=S, local_steps=K, lr=LR, bits=8,
                    swt=SWT, kernel_backend="cuda")
    part, test = make_federated_classification(
        SEED, N_CLIENTS, d=d_in, n_classes=n_cls, iid=False,
        test_samples=4096, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    p0 = init_mlp_classifier(gen, d_in, d_hidden, n_cls)
    return fed, part, test, p0, gen


def run_main_path(dev, uplink, participation=None, name="quafl", bits=8,
                  **kw):
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import simulate
    from repro_torch.models.mlp import mlp_loss, mlp_loss_batched
    fed, part, test, p0, gen = chip_world(dev)
    fed = dataclasses.replace(fed, bits=bits)
    alg = make_algorithm(name, fed, loss_fn=mlp_loss_batched, template=p0,
                         batch_size=32, uplink=uplink,
                         participation=participation, device=dev, **kw)
    if hasattr(alg, "part"):
        alg.part = SampleLog(alg.part)

    def acc(p):
        return {"acc": float(mlp_loss(p, test)[1]["acc"])}

    acc0 = acc(p0)["acc"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = simulate(alg, p0, part, gen, rounds=ROUNDS, eval_every=10,
                  record_every=1, eval_fn=acc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return alg, tr, acc0, wall, part


def check_main_path(tr, acc0, bits_up, bits_down):
    """Bits exact in every row (``bits_up`` one value, or one a round) and
    accuracy above round 0."""
    if isinstance(bits_up, int):
        bits_up = [bits_up] * tr.rounds
    assert tr.column("bits_up") == bits_up, (tr.column("bits_up"), bits_up)
    for row in tr.rows:
        assert row["bits_down"] == bits_down, row
    assert tr.final["bits_up_total"] == sum(bits_up)
    final = tr.final["acc"]
    assert final > acc0 and final > 0.1, (acc0, final)


def injected_round(dev, alg_cuda, state, data, gen, idx=None):
    """One round with the same injected draws (``idx`` or s random ids) on
    the cuda backend and on the torch backend; returns (max |Δ| of server
    and clients, lattice step: the round's largest γ, per-row detail)."""
    from repro_torch.compression.pipeline import round_randomness
    from repro_torch.fed.engine import clone_tree
    from repro_torch.fed.registry import make_algorithm
    fed_t = dataclasses.replace(alg_cuda.fed, kernel_backend="torch")
    alg_torch = make_algorithm("quafl", fed_t, loss_fn=alg_cuda.loss_fn,
                               template=alg_cuda.template, batch_size=32,
                               uplink=alg_cuda.uplink, device=dev)
    n, s = alg_cuda.fed.n_clients, alg_cuda.fed.s
    sg, u_cl, u_srv = round_randomness(gen, s, alg_cuda.d)
    if idx is None:
        idx = torch.randperm(n, generator=gen, device=dev)[:s]
    draws = {"idx": idx,
             "h_steps": torch.randint(0, K + 1, (s,), generator=gen,
                                      device=dev),
             "batch_idx": torch.randint(0, data["y"].shape[1], (s, K, 32),
                                        generator=gen, device=dev),
             "signs": sg, "u_cl": u_cl, "u_srv": u_srv}
    outs, gams, codes = [], [], []
    for alg in (alg_cuda, alg_torch):
        seen, sent = [], {}
        pipe = alg.pipeline
        inner = (pipe.gammas, pipe.rotate_encode, pipe.quantize)

        def logged(*a, _inner=inner[0], _seen=seen, **k):
            g = _inner(*a, **k)
            _seen.append(g)
            return g

        def enc(*a, _inner=inner[1], _sent=sent, **k):
            y, c = _inner(*a, **k)
            _sent["up"] = c
            return y, c

        def quant(*a, _inner=inner[2], _sent=sent, **k):
            _sent["dn"] = _inner(*a, **k)
            return _sent["dn"]
        pipe.gammas, pipe.rotate_encode, pipe.quantize = logged, enc, quant
        st, _ = alg.round(clone_tree(state), data, None, draws=draws)
        pipe.gammas, pipe.rotate_encode, pipe.quantize = inner
        outs.append(st)
        gams.append(seen)
        codes.append(sent)
    a, b = outs
    srv = float((a.server - b.server).abs().max())
    rows = (a.clients[idx] - b.clients[idx]).abs().amax(1)
    diff = max(srv, float((a.clients - b.clients).abs().max()))
    step = max(float(g.max()) for seen in gams for g in seen)
    # the uplink's (s,) γ row, then the downlink's (1,); either backend's
    gam_up = torch.maximum(gams[0][0], gams[1][0])
    gam_dn = max(float(gams[0][1].max()), float(gams[1][1].max()))
    detail = {"server": srv, "client_rows": rows.tolist(),
              "gam_up": gam_up.tolist(), "gam_dn": gam_dn,
              "avg_mode": alg_cuda.avg_mode, "codes": codes,
              "levels": alg_cuda.codec_up.wire(idx).levels}
    return diff, step, detail


def check_grouped_round(detail, s):
    """The grouped injected round held per message: uplink codes within
    ±1 of the plain version's at each row's own modulus 2^b_i, on at most
    ``ENC_MISMATCH_FRAC`` of them, the downlink codes then equal. When
    every code agrees, the rotations, snaps and averages are exact, so the
    server and every client row must be bit-equal. Otherwise each row keeps
    the room of its own messages: a code off by one moves its rotated
    coordinate by that message's γ times its weight in the average (up to
    √block such codes a block), Σ_i γ_up,i · w_srv for the server, and
    γ_dn · w_cl for client rows, which see the uplink only through
    hint_srv."""
    kern, plain = detail["codes"]
    up_k, up_p, dn_k, dn_p = kern["up"], plain["up"], kern["dn"], plain["dn"]
    L = detail["levels"].to(torch.int64)[:, None]
    gap = code_gap(up_k, up_p, L)
    res = {"up_mismatches": int((gap > 0).sum()),
           "up_max_gap": int(gap.max()),
           "dn_mismatches": int((dn_k != dn_p).sum()),
           "server_diff": detail["server"],
           "client_row_diff_max": max(detail["client_rows"])}
    assert res["up_max_gap"] <= 1, res
    assert res["up_mismatches"] <= ENC_MISMATCH_FRAC * up_k.numel(), res
    if res["up_mismatches"] == 0:
        assert res["dn_mismatches"] == 0, res
        assert res["server_diff"] == res["client_row_diff_max"] == 0.0, res
        return res
    mode = detail["avg_mode"]
    w_srv = 1 / (s + 1) if mode in ("both", "server_only") else 1 / s
    w_cl = 1 / (s + 1) if mode in ("both", "client_only") else 1.0
    res["server_bound"] = sum(detail["gam_up"]) * w_srv
    res["client_row_bound"] = detail["gam_dn"] * w_cl
    assert res["server_diff"] <= res["server_bound"], res
    assert res["client_row_diff_max"] <= res["client_row_bound"], res
    return res


# ---------------------------------------------------------------------------
# phase 5: the paper's baselines through compare()
# ---------------------------------------------------------------------------

# (run name, registry name, kwargs, bits up and bits down per round at
#  d=25,450 / d_pad=32,768, fused_decode launches per round)
BASELINES = (
    ("fedavg", "fedavg", {}, 13_030_400, 13_030_400, 0),
    ("compressed_fedavg", "compressed_fedavg", {}, 4_194_816, 814_400, 1),
    ("compressed_fedavg_scalar", "compressed_fedavg", {"uplink": "scalar"},
     3_258_112, 814_400, 0),
    ("fedbuff_lattice", "fedbuff", {"quantize": True, "quantizer": "lattice"},
     2_621_760, 8_144_000, 10),
    ("fedbuff_qsgd", "fedbuff", {"quantize": True, "quantizer": "qsgd"},
     2_036_320, 8_144_000, 0),
    ("sequential", "sequential", {}, 0, 0, 0),
    # top-k with error feedback, k = 254 of 25,450 (index + value, 64 bits)
    ("compressed_fedavg_topk_ef", "compressed_fedavg", {"uplink": TOPK},
     S * TOPK_BITS, 814_400, 0),
    ("fedbuff_topk_ef", "fedbuff", {"uplink": TOPK}, 10 * TOPK_BITS,
     8_144_000, 0),
)
COUNTED = ("fused_encode", "fused_decode")


class CountedRounds:
    """An algorithm whose rounds record the encode and decode launches each
    one made."""

    def __init__(self, kx, alg):
        self.kx = kx
        self.alg = alg
        self.per_round = []

    def __getattr__(self, name):
        return getattr(self.alg, name)

    def round(self, state, data, generator):
        before = {k: self.kx.LAUNCHES[k] for k in COUNTED}
        out = self.alg.round(state, data, generator)
        self.per_round.append({k: self.kx.LAUNCHES[k] - before[k]
                               for k in COUNTED})
        return out


def run_baselines(dev, kx):
    """compare() of the six baseline runs at the main path's width."""
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import compare
    from repro_torch.models.mlp import mlp_loss, mlp_loss_batched
    fed, part, test, p0, gen = chip_world(dev)
    algs = {run: CountedRounds(kx, make_algorithm(
                name, fed, loss_fn=mlp_loss_batched, template=p0,
                batch_size=32, device=dev, **kw))
            for run, name, kw, *_ in BASELINES}

    def evaluate(p):
        loss, aux = mlp_loss(p, test)
        return {"loss": float(loss), "acc": float(aux["acc"])}

    base = evaluate(p0)
    torch.cuda.synchronize()
    traces = compare(algs, p0, part, gen, rounds=ROUNDS, eval_every=10,
                     record_every=1, eval_fn=evaluate)
    torch.cuda.synchronize()
    return algs, traces, base, part, gen


def check_baselines(algs, traces, base):
    """Bits exact in every round, accuracy above round 0 (loss finite for
    the sequential node), and the decode launches of each round."""
    out = []
    for run, _, _, up, down, decodes in BASELINES:
        tr, alg = traces[run], algs[run]
        row = {"run": run, "rounds": tr.rounds,
               "d": int(tr.final_state.server.shape[0]),
               "ms_per_round": tr.wall_time_s / tr.rounds * 1e3,
               "bits_up": sorted(set(tr.column("bits_up"))),
               "bits_down": sorted(set(tr.column("bits_down"))),
               "acc_round0": base["acc"],
               "acc": [(r["round"], r["acc"]) for r in tr.rows if "acc" in r],
               "loss_final": tr.final["loss"],
               "quant_err_final": tr.final["quant_err"],
               "sim_time_final": tr.final["sim_time"],
               "launches_per_round": sorted({tuple(sorted(p.items()))
                                             for p in alg.per_round})}
        out.append(row)
        emit({"phase": "baselines", **row})
        assert tr.rounds == ROUNDS and row["d"] == D_MLP, row
        assert row["bits_up"] == [up] and row["bits_down"] == [down], row
        assert all(p["fused_decode"] == decodes for p in alg.per_round), row
        assert math.isfinite(row["loss_final"]), row
        if run != "sequential":
            assert tr.final["acc"] > base["acc"], row
    return out


class CodeLog:
    """A codec that records every message it encodes."""

    def __init__(self, codec):
        self.codec = codec
        self.msgs = []

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def encode(self, key, x, hint=None):
        msg = self.codec.encode(key, x, hint)
        self.msgs.append(msg)
        return msg


def injected_cfa_round(dev, alg_cuda, state, data, gen):
    """One compressed_fedavg round with the same injected draws on the cuda
    backend and on the torch backend; returns (max |Δ| of the server,
    lattice step)."""
    from repro_torch.fed.registry import make_algorithm
    fed_t = dataclasses.replace(alg_cuda.fed, kernel_backend="torch")
    alg_torch = make_algorithm("compressed_fedavg", fed_t,
                               loss_fn=alg_cuda.loss_fn,
                               template=alg_cuda.template, batch_size=32,
                               device=dev)
    n, s, d = alg_cuda.fed.n_clients, alg_cuda.fed.s, alg_cuda.d
    draws = {"idx": torch.randperm(n, generator=gen, device=dev)[:s],
             "batch_idx": torch.randint(0, data["y"].shape[1], (s, K, 32),
                                        generator=gen, device=dev),
             "durations": 10.0 * torch.rand((s,), generator=gen, device=dev),
             "key_up": alg_cuda.codec_up.keys(gen, s, d),
             "key_dn": alg_cuda.codec_down.keys(gen, 1, d)}
    servers, steps = [], []
    for alg in (alg_cuda, alg_torch):
        codec = alg.codec_up
        alg.codec_up = CodeLog(codec)
        st, _ = alg.round(state, data, None, draws=draws)
        steps.append(max(float(m.gamma.max()) for m in alg.codec_up.msgs))
        alg.codec_up = codec
        servers.append(st.server)
    return float((servers[0] - servers[1]).abs().max()), max(steps)


# a pattern (re.search) of each wrapper's kernel symbol, demangled (the
# profiler) or mangled (a graph's dump); the uplink's finish kernel
# (snap_vec_kernel_up_finish) is its second launch and is not counted
KERNEL_SYMBOLS = {"fused_encode": "encode_cluster_kernel",
                  "fused_rotate": "rotate_cluster_kernel",
                  "quantize_codes": "quantize_vec_kernel",
                  "snap_codes": "snap_vec_kernel(?!_)",
                  "fused_decode": "decode_cluster_kernel",
                  "uplink": "snap_vec_kernel_up_average",
                  "average": "snap_vec_kernel_down_average"}


def device_events(prof):
    """The profiler's averages of the kernels that ran on the card."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def ms_per_launch(kernels, symbols: dict) -> dict:
    """Mean device ms per launch of each named kernel (None if it never
    ran), from ``device_events``; ``symbols`` maps names to a substring of
    the kernel's symbol, or a pattern of it."""
    out = {}
    for name, sym in symbols.items():
        hits = [e for e in kernels if re.search(sym, e.key)]
        count = sum(e.count for e in hits)
        out[name] = (sum(e.self_device_time_total for e in hits) / count
                     / 1e3 if count else None)
    return out


def profile_rounds(alg, state, data, gen, rounds: int = 5):
    """torch.profiler over a few main-path rounds: wall time, device time
    summed over kernels, the top kernels by device time, and the mean
    device time per launch of each ported kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, _ = alg.round(state, data, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    per_launch = ms_per_launch(kernels, KERNEL_SYMBOLS)
    return {"rounds": rounds, "wall_ms_per_round": wall_us / rounds / 1e3,
            "device_ms_per_round": device_us / rounds / 1e3,
            "device_busy_share": device_us / wall_us,
            "kernel_launches_per_round": sum(e.count for e in kernels)
            / rounds,
            "top_kernels": [(e.key[:70], e.count // rounds,
                             e.self_device_time_total / rounds / 1e3)
                            for e in top],
            "ported_device_ms_per_launch": per_launch}


# ---------------------------------------------------------------------------
# phase 5b: QuAFL's grouped uplink, participation specs and per-message
# branch, and the quickstart
# ---------------------------------------------------------------------------

# (run, uplink, participation, bits up a round or None for the grouped
#  uplink's per-round sum, whether the rotated-space pipeline runs)
VARIANTS = (
    ("grouped", GROUPED, None, None, True),
    ("cyclic", "lattice", CYCLIC, 4_194_816, True),
    ("gamma_straggler", "lattice", GAMMA, 4_194_816, True),
    ("per_message", "scalar", None, 3_258_112, False),
)


def run_variants(dev, kx, uniform_per_run):
    """Each variant at the main path's width, 30 rounds, its launch counts
    from 0 just before and read just after: bits exact in every round
    (the grouped uplink's from each round's sampled ids), accuracy above
    round 0, the pipeline's rotation counts, the cyclic cohort inside its
    phase group, and the launches: the pipeline's those of the uniform b=8
    run (``uniform_per_run``), the per-message branch's one lattice
    downlink encode and one broadcast decode a round."""
    out = {}
    for run, uplink, participation, bits_up, pipelined in VARIANTS:
        kx.reset_launches()
        alg, tr, acc0, wall, data = run_main_path(dev, uplink, participation)
        torch.cuda.synchronize()
        launches = dict(kx.LAUNCHES)
        ids = [i.cpu() for i in alg.part.ids]
        if bits_up is None:
            per = alg.codec_up.message_bits_per_client(alg.d)
            assert per[:N_SLOW].tolist() == [SLOW_BITS] * N_SLOW
            assert per[N_SLOW:].tolist() == [FAST_BITS] * (N_CLIENTS - N_SLOW)
            bits_up = [grouped_bits_up(i) for i in ids]
            assert bits_up == [int(per[i.numpy()].sum()) for i in ids]
        row = {"phase": "main_path", "run": run, "uplink": str(uplink),
               "participation": participation, "rounds": tr.rounds,
               "d": alg.d, "n_clients": N_CLIENTS, "s": S,
               "bits_up": tr.column("bits_up"),
               "bits_down": tr.column("bits_down"),
               "slow_per_round": [int((i < N_SLOW).sum()) for i in ids],
               "quant_err_final": tr.final["quant_err"], "acc_round0": acc0,
               "acc": [(r["round"], r["acc"]) for r in tr.rows if "acc" in r],
               "seconds": wall, "ms_per_round": wall / tr.rounds * 1e3,
               "launches": launches}
        if pipelined:
            row["rotations"] = alg.pipeline.stats.counts()
        emit(row)
        check_main_path(tr, acc0, bits_up, BITS_DOWN)
        assert len(ids) == ROUNDS and all(len(set(i.tolist())) == S
                                          for i in ids), run
        if pipelined:
            assert row["rotations"] == {"rotation_fwd": ROUNDS * (S + 1),
                                        "rotation_inv": ROUNDS * (S + 1)}
            assert launches == uniform_per_run, (launches, uniform_per_run)
        else:
            assert alg.pipeline is None
            assert launches == {**{k: 0 for k in launches},
                                "fused_encode": ROUNDS,
                                "fused_decode": ROUNDS}, launches
        if participation == CYCLIC:
            groups = [sorted({int(x) // (N_CLIENTS // 4) for x in i})
                      for i in ids]
            assert groups == [[(t // 2) % 4] for t in range(ROUNDS)], groups
        out[run] = (alg, tr, data)
    return out


QUICKSTART = (   # (run, registry name, kwargs, bits up, bits down a round)
    ("quafl", "quafl", {}, 4_194_816, BITS_DOWN),
    ("quafl_het", "quafl", {"uplink": GROUPED}, None, BITS_DOWN),
    ("fedavg", "fedavg", {}, 13_030_400, 13_030_400),
    ("fedpaq", "compressed_fedavg", {"uplink": "scalar"}, 3_258_112,
     814_400),
)


def run_quickstart(dev, kx):
    """The quickstart's four runs through ``compare`` at the main path's
    width and an equal simulated time of 30 QuAFL rounds, counts from 0
    just before and read just after: bits exact in every round, QuAFL's
    30 rounds, accuracy above round 0."""
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import compare
    from repro_torch.models.mlp import mlp_loss, mlp_loss_batched
    fed, part, test, p0, gen = chip_world(dev)
    algs = {run: make_algorithm(name, fed, loss_fn=mlp_loss_batched,
                                template=p0, batch_size=32, device=dev, **kw)
            for run, name, kw, *_ in QUICKSTART}
    algs["quafl_het"].part = SampleLog(algs["quafl_het"].part)

    def acc(p):
        return {"acc": float(mlp_loss(p, test)[1]["acc"])}

    acc0 = acc(p0)["acc"]
    kx.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traces = compare(algs, p0, part, gen,
                     until_sim_time=ROUNDS * (fed.swt + fed.sit),
                     eval_every=10, record_every=1, eval_fn=acc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kx.LAUNCHES)
    rows = []
    for run, _, _, up, down in QUICKSTART:
        tr = traces[run]
        if up is None:
            up = [grouped_bits_up(i) for i in algs[run].part.ids]
        row = {"phase": "quickstart", "run": run, "rounds": tr.rounds,
               "bits_up": sorted(set(tr.column("bits_up"))),
               "bits_down": sorted(set(tr.column("bits_down"))),
               "bits_up_total": tr.final["bits_up_total"],
               "bits_down_total": tr.final["bits_down_total"],
               "sim_time_final": tr.final["sim_time"], "acc_round0": acc0,
               "acc_final": tr.final["acc"],
               "ms_per_round": tr.us_per_round / 1e3}
        rows.append(row)
        emit(row)
        check_main_path(tr, acc0, up, down)
        if run.startswith("quafl"):
            assert tr.rounds == ROUNDS, row
    emit({"phase": "launches", "path": "quickstart", "launches": launches,
          "seconds": wall})
    for k in ("fused_encode", "fused_rotate", "quantize_codes", "uplink",
              "average"):
        assert launches[k] > 0, f"kernel {k} never launched on the " \
            f"quickstart"
    h, q = traces["quafl_het"].final, traces["quafl"].final
    assert q["bits_up_total"] / h["bits_up_total"] > 1.0
    return rows


def run_twin_clis():
    """``python -m repro_torch.examples.quickstart``,
    ``...heterogeneous_clients`` and ``...scaffold_noniid`` as a user runs
    them, each in its own process on the card; their printed lines, the
    quickstart's and SCAFFOLD's tables, both heterogeneous-uplink ratios
    above 1 and every printed ‖c‖ above 0."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for name in ("quickstart", "heterogeneous_clients", "scaffold_noniid"):
        argv = [sys.executable, "-m", f"repro_torch.examples.{name}"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        lines = proc.stdout.splitlines()
        emit({"phase": "twin_cli", "module": f"repro_torch.examples.{name}",
              "rc": proc.returncode, "seconds": time.perf_counter() - t0,
              "lines": lines, "stderr_tail": proc.stderr[-2000:]})
        assert proc.returncode == 0, proc.stderr[-2000:]
        text = proc.stdout
        if name == "scaffold_noniid":
            assert lines[0] == "round |  vanilla acc | scaffold acc | ||c||"
            rows = [ln.split("|") for ln in lines[1:6]]
            assert [int(r[0]) for r in rows] == [16, 32, 48, 64, 80], lines
            assert all(0.0 <= float(r[2]) <= 1.0 and float(r[3]) > 0.0
                       for r in rows), lines
            assert "SCAFFOLD pays 2x" in text, lines
            continue
        if name == "quickstart":
            assert lines[0].startswith("algorithm | rounds"), lines
            assert [ln.split()[0] for ln in lines[1:5]] == [
                "quafl", "quafl_het", "fedavg", "fedpaq"], lines
            ratio = float(text.split("uplink (slow 30% at b=4) sends ")[1]
                          .split("x")[0])
        else:
            assert "cyclic availability:" in text, lines
            ratio = float(text.split("uplink bits=")[2].split("(")[1]
                          .split("x")[0])
        assert ratio > 1.0, (name, ratio)


# ---------------------------------------------------------------------------
# phase 5c: the extensions (quafl_scaffold, adaptive_quafl) and top-k with
# error feedback
# ---------------------------------------------------------------------------

def run_scaffold(dev, kx):
    """quafl_scaffold at the main path's width, lattice b=8 both ways, 30
    rounds, counts from 0 just before and read just after: bits exact in
    every round, accuracy above round 0, ‖c‖ finite and above 0, and three
    encode and three decode launches a round (the models, the controls,
    the downlink)."""
    kx.reset_launches()
    alg, tr, acc0, wall, data = run_main_path(dev, "lattice",
                                              name="quafl_scaffold")
    torch.cuda.synchronize()
    launches = dict(kx.LAUNCHES)
    c_norm = tr.column("c_norm")
    emit({"phase": "main_path", "run": "quafl_scaffold", "rounds": tr.rounds,
          "d": alg.d, "n_clients": N_CLIENTS, "s": S,
          "bits_up": sorted(set(tr.column("bits_up"))),
          "bits_down": sorted(set(tr.column("bits_down"))),
          "c_norm": c_norm, "quant_err_final": tr.final["quant_err"],
          "acc_round0": acc0,
          "acc": [(r["round"], r["acc"]) for r in tr.rows if "acc" in r],
          "seconds": wall, "ms_per_round": wall / tr.rounds * 1e3,
          "launches": launches})
    emit({"phase": "launches", "path": "quafl_scaffold",
          "launches": launches})
    check_main_path(tr, acc0, SCAFFOLD_UP, SCAFFOLD_DOWN)
    assert all(math.isfinite(c) and c > 0 for c in c_norm), c_norm
    assert launches == {**{k: 0 for k in launches},
                        "fused_encode": 3 * ROUNDS,
                        "fused_decode": 3 * ROUNDS}, launches
    return alg, tr, data, launches


def injected_scaffold_round(dev, alg_cuda, state, data, gen):
    """One quafl_scaffold round with the same state and injected draws on
    the cuda backend and on the torch backend (the kernels' plain
    versions). Each of the three messages' codes equal, or ±1 mod L on at
    most ``ENC_MISMATCH_FRAC`` of them; the server, the clients, the
    controls and c within one lattice step (the round's largest γ), and
    bit-equal when every code agrees."""
    from repro_torch.fed.engine import clone_tree
    from repro_torch.fed.registry import make_algorithm
    fed_t = dataclasses.replace(alg_cuda.fed, kernel_backend="torch")
    alg_torch = make_algorithm("quafl_scaffold", fed_t,
                               loss_fn=alg_cuda.loss_fn,
                               template=alg_cuda.template, batch_size=32,
                               device=dev)
    n, s, d = alg_cuda.fed.n_clients, alg_cuda.fed.s, alg_cuda.d
    up, dn = alg_cuda.codec_up, alg_cuda.codec_down
    draws = {"idx": torch.randperm(n, generator=gen, device=dev)[:s],
             "h_steps": torch.randint(0, K + 1, (s,), generator=gen,
                                      device=dev),
             "batch_idx": torch.randint(0, data["y"].shape[1], (s, K, 32),
                                        generator=gen, device=dev),
             "key_up": up.keys(gen, s, d), "key_ctl": up.keys(gen, s, d),
             "key_dn": dn.keys(gen, 1, d)}
    outs, msgs = [], []
    for alg in (alg_cuda, alg_torch):
        codecs = alg.codec_up, alg.codec_down
        alg.codec_up, alg.codec_down = CodeLog(codecs[0]), CodeLog(codecs[1])
        st, _ = alg.round(clone_tree(state), data, None, draws=draws)
        msgs.append(alg.codec_up.msgs + alg.codec_down.msgs)
        alg.codec_up, alg.codec_down = codecs
        outs.append(st)
    a, b = outs
    L = 1 << up.bits
    res = {"phase": "injected_round", "algorithm": "quafl_scaffold"}
    for name, mk, mp in zip(("models", "controls", "downlink"), *msgs):
        gap = code_gap(mk.codes, mp.codes, L)
        res[f"{name}_mismatches"] = int((gap > 0).sum())
        res[f"{name}_max_gap"] = int(gap.max())
        res[f"{name}_gamma_max"] = float(torch.maximum(mk.gamma,
                                                       mp.gamma).max())
        assert res[f"{name}_max_gap"] <= 1, res
        assert res[f"{name}_mismatches"] <= ENC_MISMATCH_FRAC * gap.numel(), \
            res
    step = max(res[f"{k}_gamma_max"] for k in ("models", "controls",
                                               "downlink"))
    diffs = {"server": (a.base.server, b.base.server),
             "clients": (a.base.clients, b.base.clients),
             "controls": (a.c_clients, b.c_clients),
             "c_server": (a.c_server, b.c_server)}
    for k, (x, y) in diffs.items():
        res[f"{k}_diff"] = float((x - y).abs().max())
    res["lattice_step"] = step
    emit(res)
    if not any(res[f"{k}_mismatches"] for k in ("models", "controls",
                                                 "downlink")):
        assert all(res[f"{k}_diff"] == 0.0 for k in diffs), res
    assert all(res[f"{k}_diff"] <= step for k in diffs), res
    return res


def storage_bits(b: int) -> int:
    return 8 if b <= 8 else 16


def run_adaptive(dev, kx):
    """adaptive_quafl from b=12 at the main path's width, 30 rounds, counts
    from 0 just before and read just after: the printed width trace equal
    to the walk recomputed from the emitted ``quant_err``, each round's
    bits exact at that round's width, accuracy above round 0, and the
    launches of a b=8 QuAFL round at every width: one encode, three
    rotations, one quantize and two snaps a round, no decode."""
    from repro_torch.core.extensions import AdaptiveBits
    kx.reset_launches()
    alg, tr, acc0, wall, data = run_main_path(
        dev, None, name="adaptive_quafl", bits=ADAPTIVE_BITS0, **ADAPTIVE)
    torch.cuda.synchronize()
    launches = dict(kx.LAUNCHES)
    widths = [int(w) for w in tr.column("bits_width")]
    errs = tr.column("quant_err")
    walk, b = [], ADAPTIVE_BITS0
    for e in errs:
        walk.append(b)
        b = AdaptiveBits.walk(b, e, **ADAPTIVE)
    per = [32_768 * storage_bits(w) + 32 for w in widths]
    emit({"phase": "main_path", "run": "adaptive_quafl", "rounds": tr.rounds,
          "d": alg._alg(ADAPTIVE_BITS0).d, "n_clients": N_CLIENTS, "s": S,
          **ADAPTIVE, "bits_start": ADAPTIVE_BITS0, "bits_width": widths,
          "widths_visited": sorted(set(widths)), "quant_err": errs,
          "bits_up": tr.column("bits_up"),
          "bits_down": tr.column("bits_down"), "acc_round0": acc0,
          "acc": [(r["round"], r["acc"]) for r in tr.rows if "acc" in r],
          "seconds": wall, "ms_per_round": wall / tr.rounds * 1e3,
          "launches": launches})
    emit({"phase": "launches", "path": "adaptive_quafl",
          "launches": launches})
    assert widths == walk and tuple(widths) == tr.final_state.trace, \
        (widths, walk)
    assert tr.final_state.bits == b
    assert tr.column("bits_up") == [S * p for p in per]
    assert tr.column("bits_down") == per
    assert tr.final["acc"] > acc0 and tr.final["acc"] > 0.1
    assert launches == {**{k: 0 for k in launches},
                        "fused_encode": ROUNDS, "fused_rotate": 3 * ROUNDS,
                        "quantize_codes": ROUNDS,
                        "uplink": ROUNDS, "average": ROUNDS}, launches
    return alg, tr, data, launches


class EFLog:
    """A stateful codec that records its encodes and its last decode."""

    def __init__(self, codec):
        self.codec = codec
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def encode_stateful(self, key, x, hint, state):
        msg, new = self.codec.encode_stateful(key, x, hint, state)
        self.calls.append((x, state, msg, new))
        return msg, new

    def decode(self, key, msg, ref):
        self.decoded = self.codec.decode(key, msg, ref)
        return self.decoded


def injected_ef_round(dev, alg, state, data, gen):
    """One compressed_fedavg round with a ``topk_ef`` uplink on the card,
    draws injected: decoded + new residual == delta + old residual, bit for
    bit; the sampled clients' rows are the new residuals, every other row
    as it was; and the same messages on the CPU pick the same index sets
    and values and leave the same residuals."""
    n, s, d = alg.fed.n_clients, alg.fed.s, alg.d
    idx = torch.randperm(n, generator=gen, device=dev)[:s]
    draws = {"idx": idx,
             "batch_idx": torch.randint(0, data["y"].shape[1], (s, K, 32),
                                        generator=gen, device=dev),
             "durations": 10.0 * torch.rand((s,), generator=gen, device=dev),
             "key_up": alg.codec_up.keys(gen, s, d),
             "key_dn": alg.codec_down.keys(gen, 1, d)}
    before = state.codec_up_state.clone()
    codec = alg.codec_up
    alg.codec_up = EFLog(codec)
    st, _ = alg.round(state, data, None, draws=draws)
    (x, old, msg, new), = alg.codec_up.calls
    dec = alg.codec_up.decoded
    alg.codec_up = codec
    rest = torch.ones(n, dtype=torch.bool, device=dev)
    rest[idx] = False
    msg_c, new_c = codec.encode_stateful(None, x.cpu(), None, old.cpu())
    sets = torch.equal(torch.sort(msg.idx.cpu(), 1).values,
                       torch.sort(msg_c.idx, 1).values)
    # messages full of equal magnitudes at the same shape (a third exact
    # zeros): the card's selection against the CPU's, and the invariant
    tied = torch.randint(-3, 4, (s, d), generator=gen, device=dev) * 0.25
    tied[torch.rand((s, d), generator=gen, device=dev) < 0.33] = 0.0
    t_msg, t_new = codec.encode_stateful(None, tied, None, new)
    t_msg_c, t_new_c = codec.encode_stateful(None, tied.cpu(), None,
                                             new.cpu())
    t_idx, t_ord = torch.sort(t_msg.idx.cpu(), 1)
    t_idx_c, t_ord_c = torch.sort(t_msg_c.idx, 1)
    t_dec = codec.decode(None, t_msg, torch.zeros((1, d), device=dev))
    res = {"phase": "injected_round", "algorithm": "compressed_fedavg",
           "uplink": TOPK, "k": int(msg.idx.shape[1]),
           "ties_in_targets": int(((x + old) == 0).sum()),
           "ef_invariant_exact": bool(torch.equal(dec + new, x + old)),
           "sampled_rows_are_new": bool(torch.equal(
               st.codec_up_state[idx], new)),
           "other_rows_unchanged": bool(torch.equal(
               st.codec_up_state[rest], before[rest])),
           "cpu_index_sets_equal": sets,
           "cpu_residuals_equal": bool(torch.equal(new.cpu(), new_c)),
           "residual_norm": float(torch.linalg.vector_norm(new)),
           "tied_zero_targets": int(((tied + new) == 0).sum()),
           "cpu_tied_index_sets_equal": bool(torch.equal(t_idx, t_idx_c)),
           "cpu_tied_values_equal": bool(torch.equal(
               torch.gather(t_msg.vals.cpu(), 1, t_ord),
               torch.gather(t_msg_c.vals, 1, t_ord_c))),
           "cpu_tied_residuals_equal": bool(torch.equal(t_new.cpu(),
                                                        t_new_c)),
           "ef_invariant_tied_exact": bool(torch.equal(t_dec + t_new,
                                                       tied + new))}
    emit(res)
    assert all(v for k, v in res.items() if k.startswith(
        ("ef_", "sampled", "other", "cpu_"))), res
    return res


# ---------------------------------------------------------------------------
# phase 5d: the round engine — chunks of rounds captured as CUDA graphs
# ---------------------------------------------------------------------------

ENGINE_CHUNK = 10                 # rounds a chunk, as a user passes it
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 5e-7   # the reference's lattice-chunk
#                                       # tolerance (tests/test_engine.py)
ENGINE_REPEATS = 3                # eager, K and "auto" in turns
FEDBUFF_Z = 10
# (run, registry name, kwargs); fedbuff_device also gets the seed bridge's
# table from the run's seed
ENGINE_RUNS = (
    ("quafl", "quafl", {"uplink": "lattice"}),
    ("quafl_packed4", "quafl", {"uplink": "lattice_packed:bits=4"}),
    ("compressed_fedavg", "compressed_fedavg", {}),
    ("fedbuff_device", "fedbuff_device",
     {"quantize": True, "quantizer": "lattice", "buffer_size": FEDBUFF_Z}),
    ("quafl_scaffold", "quafl_scaffold", {"uplink": "lattice"}),
    ("fedavg", "fedavg", {}),
    ("sequential", "sequential", {}),
    ("adaptive_quafl", "adaptive_quafl", ADAPTIVE),
)


def port_launches(kernels) -> dict:
    """Launches of each port kernel, from the profiler's device events
    (a graph replay's kernels among them)."""
    return {k: sum(e.count for e in kernels if re.search(sym, e.key))
            for k, sym in KERNEL_SYMBOLS.items()}


def profiled(fn):
    """``fn()`` under torch.profiler: (result, wall seconds, the device
    events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, device_events(prof)


def plain_chunks(alg):
    """The adaptive walk's engines without capture: the same chunks, walk
    once per chunk, each round run eagerly through ``device_round`` (its
    width schedule differs from the eager per-round walk by design)."""
    from repro_torch.fed.engine import RoundEngine
    for b in range(alg.b_min, alg.b_max + 1):
        alg._engines[b] = RoundEngine(alg._alg(b), capture=False)
    return alg


def engine_graph_times(alg) -> dict:
    from repro_torch.fed.simulate import round_engine
    engines = getattr(alg, "_engines", None)
    if engines is not None:
        return {b: e.graph_times() for b, e in engines.items()
                if e.graph_times()}
    return round_engine(alg).graph_times()


def check_engine_run(alg, ref, tr) -> dict:
    """The chunked trace against the eager one: bits up and down and
    sim_time exact every round, the final server within the reference's
    lattice-chunk tolerance (max |Δ| and the unequal count printed)."""
    from repro_torch.utils.tree import tree_flatten_vector
    for key in ("bits_up", "bits_down", "sim_time"):
        assert tr.column(key) == ref.column(key), (key, tr.column(key),
                                                   ref.column(key))
    a = tree_flatten_vector(alg.eval_params(ref.final_state))
    b = tree_flatten_vector(alg.eval_params(tr.final_state))
    res = {"server_max_abs_diff": float((a - b).abs().max()),
           "server_unequal": int((a != b).sum()), "rounds": tr.rounds}
    torch.testing.assert_close(b, a, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    return res


def fedbuff_bridge(dev, fed, p0, part, gen, table, kw):
    """fedbuff_device (eager rounds, the table from the run's seed)
    against the host fedbuff on the card from copies of one generator:
    the pop order exact, event times within rtol 1e-6 (fp32 ring, fp64
    heap), bits exact every flush, the server within rtol 1e-5, atol 1e-6
    (the reference's bridge tolerance), the same draws consumed."""
    from repro_torch.core import fedbuff as fb
    from repro_torch.fed.clock import ArrivalQueue
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.models.mlp import mlp_loss_batched
    mk = dict(loss_fn=mlp_loss_batched, template=p0, batch_size=32,
              device=dev, **kw)
    py = make_algorithm("fedbuff", fed, **mk)
    dv = make_algorithm("fedbuff_device", fed, completion_table=table, **mk)
    pops = {"py": [], "dev": []}
    heap_pop, ring_pop = ArrivalQueue.pop, fb.ring_pop

    def log_heap(self):
        ev = heap_pop(self)
        pops["py"].append(ev)
        return ev

    def log_ring(rb):
        out = ring_pop(rb)
        pops["dev"].append(out[1:])
        return out

    g_py, g_dv = (torch.Generator(device=dev) for _ in range(2))
    g_py.set_state(gen.get_state())
    g_dv.set_state(gen.get_state())
    ArrivalQueue.pop, fb.ring_pop = log_heap, log_ring
    try:
        sp, sd = py.init(p0), dv.init(p0)
        rows = []
        for _ in range(ROUNDS):
            sp, mp = py.round(sp, part, g_py)
            sd, md = dv.round(sd, part, g_dv)
            rows.append((mp["bits_up"], md["bits_up"], mp["bits_down"],
                         md["bits_down"], mp["sim_time"],
                         float(md["sim_time"])))
    finally:
        ArrivalQueue.pop, fb.ring_pop = heap_pop, ring_pop
    dev_pops = [(float(t), int(c)) for t, c in pops["dev"]]
    t_py = np.array([t for t, _ in pops["py"]])
    t_dv = np.array([t for t, _ in dev_pops])
    res = {"phase": "engine_fedbuff_bridge", "flushes": ROUNDS,
           "pops": len(dev_pops),
           "pop_order_equal": [c for _, c in dev_pops]
           == [c for _, c in pops["py"]],
           "pop_time_max_rel": float(np.max(np.abs(t_dv - t_py)
                                            / np.abs(t_py))),
           "bits_equal": all(a == b and c == d
                             for a, b, c, d, _, _ in rows),
           "sim_time_max_rel": max(abs(b - a) / a
                                   for *_, a, b in rows),
           "server_max_abs_diff": float((sd.server - sp.server).abs().max()),
           "generators_equal": bool(torch.equal(g_py.get_state(),
                                                g_dv.get_state()))}
    emit(res)
    assert res["pops"] == ROUNDS * FEDBUFF_Z and res["pop_order_equal"], res
    assert res["pop_time_max_rel"] <= 1e-6, res
    assert res["sim_time_max_rel"] <= 1e-6 and res["bits_equal"], res
    assert res["generators_equal"], res
    torch.testing.assert_close(sd.server, sp.server, rtol=1e-5, atol=1e-6)
    return res


def run_engine(dev, kx, smi):
    """Each run at the main path's width, 30 rounds, through ``compare``
    as a user calls it, eager and scanned (K=10, then "auto") from the
    same generator state, in three alternating repeats: ms per round of
    each, the graphs' warm-up, capture and instantiate ms per chunk length,
    the chosen K; gates (every repeat's scanned trace against the eager
    one): bits up and down and sim_time exact every round, the server
    within rtol 1e-4, atol 5e-7; then a replayed run under the profiler:
    its port kernels' launches (device events) those of the eager run
    (its wrappers' counts), device ms per round and the busy share. For adaptive_quafl the eager side is the
    same chunk walk run without capture. Then fedbuff_device against the
    host fedbuff. Counts from 0 just before, read just after."""
    from repro_torch.fed.clock import speeds_for
    from repro_torch.fed.engine import (fedbuff_completion_table,
                                        fedbuff_event_seed)
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import compare
    from repro_torch.models.mlp import mlp_loss, mlp_loss_batched
    fed, part, test, p0, gen = chip_world(dev)
    table = fedbuff_completion_table(
        fedbuff_event_seed(gen), speeds_for(fed, N_CLIENTS), K,
        FEDBUFF_Z * ROUNDS)

    def acc(p):
        return {"acc": float(mlp_loss(p, test)[1]["acc"])}

    def build(name, kw):
        f = fed
        if name == "adaptive_quafl":
            f = dataclasses.replace(fed, bits=ADAPTIVE_BITS0)
        if name == "fedbuff_device":
            kw = {**kw, "completion_table": table}
        return make_algorithm(name, f, loss_fn=mlp_loss_batched, template=p0,
                              batch_size=32, device=dev, **kw)

    def go(alg, run, chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = compare({run: alg}, p0, part, gen, rounds=ROUNDS,
                     eval_every=10, record_every=1, eval_fn=acc,
                     scan_chunk=chunk)[run]
        torch.cuda.synchronize()
        return tr, time.perf_counter() - t0

    kx.reset_launches()
    t_phase = time.perf_counter()
    out = {}
    for run, name, kw in ENGINE_RUNS:
        alg = build(name, kw)
        adaptive = name == "adaptive_quafl"
        ref_alg = plain_chunks(build(name, kw)) if adaptive else alg
        times = {"eager": [], "chunk": [], "auto": []}
        first = {}
        for rep in range(ENGINE_REPEATS):
            for mode, chunk in (("eager", 0), ("chunk", ENGINE_CHUNK),
                                ("auto", "auto")):
                a = alg
                if mode == "eager" and adaptive:
                    a, chunk = ref_alg, ENGINE_CHUNK
                before = dict(kx.LAUNCHES)
                tr, wall = go(a, run, chunk)
                times[mode].append({"ms_per_round": tr.us_per_round / 1e3,
                                    "wall_s": wall})
                if mode not in first and mode == "eager":
                    # the eager run's launches: its wrappers' counts, exact
                    launches_e = {k: kx.LAUNCHES[k] - before[k]
                                  for k in KERNEL_SYMBOLS}
                first.setdefault(mode, tr)
                if mode != "eager":
                    ref = first["eager"]
                    if adaptive and tr.scan_chunk != ENGINE_CHUNK:
                        ref = first.get(("plain", tr.scan_chunk))
                        if ref is None:
                            ref = first[("plain", tr.scan_chunk)] = go(
                                ref_alg, run, tr.scan_chunk)[0]
                    gate = check_engine_run(alg, ref, tr)
                    first.setdefault((mode, "gate"), gate)
        tr_k, tr_auto = first["chunk"], first["auto"]
        assert tr_k.engine == tr_auto.engine == "scanned", run
        assert tr_k.scan_chunk == ENGINE_CHUNK
        # a replayed run under the profiler: its port launches from the
        # device events (profiled again, up to three times, where the
        # trace dropped some, as it now and then does), device ms, busy
        for _ in range(3):
            (tr_c, _), wall_c, ev_c = profiled(lambda: go(alg, run,
                                                          ENGINE_CHUNK))
            launches_c = port_launches(ev_c)
            if launches_c == launches_e:
                break
        check_engine_run(alg, first["eager"], tr_c)
        dev_us = sum(e.self_device_time_total for e in ev_c)
        top = sorted(ev_c, key=lambda e: -e.self_device_time_total)[:8]
        row = {"phase": "engine", "run": run, "algorithm": name,
               "nvidia_smi": smi, "rounds": ROUNDS,
               "chunk": ENGINE_CHUNK, "auto_chunk": tr_auto.scan_chunk,
               "ms_per_round": {m: [t["ms_per_round"] for t in v]
                                for m, v in times.items()},
               "wall_s": {m: [t["wall_s"] for t in v]
                          for m, v in times.items()},
               "graph_ms": engine_graph_times(alg),
               "gate_chunk": first[("chunk", "gate")],
               "gate_auto": first[("auto", "gate")],
               "port_launches_per_round": {
                   k: v / ROUNDS for k, v in launches_c.items()},
               "port_launches_per_round_eager": {
                   k: v / ROUNDS for k, v in launches_e.items()},
               "ported_device_ms_per_launch": ms_per_launch(
                   ev_c, KERNEL_SYMBOLS),
               "kernels_per_round": sum(e.count for e in ev_c) / ROUNDS,
               "profiled_chunked": {
                   "wall_ms_per_round": wall_c / ROUNDS * 1e3,
                   "device_ms_per_round": dev_us / ROUNDS / 1e3,
                   "device_busy_share": dev_us / (wall_c * 1e6),
                   "top_kernels": [(e.key[:70], e.count / ROUNDS,
                                    e.self_device_time_total / ROUNDS / 1e3)
                                   for e in top]},
               "acc_final": tr_k.final["acc"]}
        if adaptive:
            row["bits_width"] = [int(w) for w in tr_k.column("bits_width")]
        emit(row)
        assert launches_e == launches_c, (run, launches_e, launches_c)
        out[run] = (alg, row)
    torch.cuda.synchronize()
    launches = dict(kx.LAUNCHES)
    emit({"phase": "launches", "path": "engine", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    used = {k for _, row in out.values()
            for k, v in row["port_launches_per_round"].items() if v}
    assert used == set(KERNEL_SYMBOLS) - {"snap_codes"}, used
    fedbuff_bridge(dev, fed, p0, part, gen, table,
                   dict(ENGINE_RUNS[3][2]))
    return out


# ---------------------------------------------------------------------------
# phase 6: flash attention against its plain version, and the serve path
# ---------------------------------------------------------------------------

GEMMA = "gemma2-2b"
SERVE_BATCH, SERVE_SEQ, SERVE_NEW = 4, 8192, 32
BF16, FP32 = torch.bfloat16, torch.float32
FLASH_TOL = {FP32: 2e-5, BF16: 3e-2}    # the JAX package's own tolerances
# bf16 also per row of dh outputs: max|Δ| <= 2^-7 max|want| + 1e-3 (one bf16
# ulp of the row's largest value, plus slack for small rows), and over the
# whole output ||Δ|| <= 1e-2 ||want||. On unit-normal inputs a typical
# output at t=4,608 is about 0.02, so the absolute 3e-2 alone would pass a
# kernel that dropped a kv tile; these two would not.
FLASH_ROW_TOL = (2.0 ** -7, 1e-3)
FLASH_REL_TOL = 1e-2
# (label, b, t, h, kv, dh, window, softcap, dtype): gemma2-2b's two serve
# batches in its global and local (window 4096) layers, llama3.2-1b's and
# olmo-1b's heads, a window that binds, MQA, and four fp32 cases (two at
# t=4,608, where the fp32 tolerance holds the late kv tiles and the
# window's lower edge to 2e-5)
FLASH_CASES = [
    ("gemma2_A_global", 4, 512, 8, 4, 256, 0, 50.0, BF16),
    ("gemma2_A_local", 4, 512, 8, 4, 256, 4096, 50.0, BF16),
    ("gemma2_B_global", 4, 4608, 8, 4, 256, 0, 50.0, BF16),
    ("gemma2_B_local", 4, 4608, 8, 4, 256, 4096, 50.0, BF16),
    ("llama3.2-1b", 4, 512, 32, 8, 64, 0, 0.0, BF16),
    ("olmo-1b", 4, 512, 16, 16, 128, 0, 0.0, BF16),
    ("window_binds", 4, 1024, 8, 4, 256, 256, 50.0, BF16),
    ("mqa", 4, 512, 8, 1, 128, 0, 0.0, BF16),
    ("gemma2_A_global_fp32", 4, 512, 8, 4, 256, 0, 50.0, FP32),
    ("llama3.2-1b_fp32", 4, 512, 32, 8, 64, 0, 0.0, FP32),
    ("gemma2_B_global_fp32", 4, 4608, 8, 4, 256, 0, 50.0, FP32),
    ("gemma2_B_local_fp32", 4, 4608, 8, 4, 256, 4096, 50.0, FP32),
    # the zoo's serve path (path 11): gemma3-12b's local and global layers,
    # llama4-scout's global NoPE layer (a GQA group of 5) in bf16 and in
    # fp32 (its consistency check), reduced jamba's attention layer (fp32)
    ("gemma3_A_local", 4, 512, 16, 8, 256, 1024, 0.0, BF16),
    ("gemma3_A_global", 4, 512, 16, 8, 256, 0, 0.0, BF16),
    ("llama4_A_global", 4, 512, 40, 8, 128, 0, 0.0, BF16),
    ("llama4_A_global_fp32", 2, 640, 40, 8, 128, 0, 0.0, FP32),
    ("jamba_reduced_B_fp32", 4, 4608, 4, 2, 32, 0, 0.0, FP32),
    # the encoder-decoder and frontend archs' decoder prefills (path 13):
    # seamless-m4t-medium's (dh 64, a GQA group of 1) and llava-next-34b's
    # (2,880 patch positions and 448 text tokens, a GQA group of 7)
    ("seamless_A", 4, 512, 16, 16, 64, 0, 0.0, BF16),
    ("llava_A", 4, 3328, 56, 8, 128, 0, 0.0, BF16),
]
FLASH_TIMED = ("gemma2_A_global", "gemma2_A_local", "gemma2_B_global",
               "gemma2_B_local", "gemma3_A_local", "gemma3_A_global",
               "llama4_A_global", "seamless_A", "llava_A")
FLASH_MAIN = "gemma2_B_global"    # the kernels line's shape, also timed
                                  # at softcap 0 beside SDPA
FLASH_SYMBOL = r"flash_(wgmma_)?kernel"   # either flash kernel, profiled
CONSIST_TOL = 1e-3                # fp32 prefill vs decode, x max|logit|


def ptxas_summary(log: str) -> dict:
    """Registers, shared memory and spills of each kernel from nvcc's
    -Xptxas=-v output; template instantiations named <type>, <type,dh>,
    <dh> (<dh,empty_rows> for the bf16 flash kernel that checks for query
    rows that see no key) or, for the cluster kernels, <cluster size> and
    <cluster size,type>."""
    dtypes = {"f": "f32", "13__nv_bfloat16": "bf16"}
    out, fn = {}, None
    for ln in log.splitlines():
        hit = re.search(r"Compiling entry function '.*?([a-z][a-z_]*_kernel)"
                        r"(I(f|13__nv_bfloat16)?(?:Li(\d+)E)?"
                        r"(f|13__nv_bfloat16)?(Lb1E)?)?", ln)
        if hit:
            fn = hit.group(1)
            if hit.group(2):
                flag = "empty_rows" if hit.group(6) else None
                args = (a for a in (dtypes.get(hit.group(3)), hit.group(4),
                                    dtypes.get(hit.group(5)), flag) if a)
                fn += f"<{','.join(args)}>"
        elif fn and ("registers" in ln or "spill" in ln):
            info = ln.split(":", 1)[-1].strip()
            out[fn] = f"{out[fn]}; {info}" if fn in out else info
    return out


def visible_pairs(t: int, window: int) -> int:
    """(query, key) pairs inside the causal band (and the window)."""
    if not window or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def flash_case(fa, dev, gen, b, t, h, kv, dh, window, cap, dtype):
    """The kernel against flash_attention_plain on unit-normal inputs."""
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, t, h, dh), (b, t, kv, dh), (b, t, kv, dh)))
    out = fa.flash_attention(q, k, v, window=window, softcap=cap).float()
    want = fa.flash_attention_plain(q, k, v, window=window,
                                    softcap=cap).float()
    torch.cuda.synchronize()
    err = (out - want).abs()
    rel, floor = FLASH_ROW_TOL
    row_excess = err.amax(-1) - (rel * want.abs().amax(-1) + floor)
    res = {"b": b, "t": t, "h": h, "kv": kv, "dh": dh, "window": window,
           "softcap": cap, "dtype": str(dtype).split(".")[1],
           "max_abs_err": float(err.max()),
           "rel_norm_err": float(torch.linalg.vector_norm(err)
                                 / torch.linalg.vector_norm(want)),
           "max_row_excess": float(row_excess.max()),
           "mean_abs_out": float(want.abs().mean()),
           "finite": bool(torch.isfinite(out).all()),
           "tol": FLASH_TOL[dtype]}
    del out, want, err, row_excess
    ok = res["finite"] and res["max_abs_err"] <= FLASH_TOL[dtype]
    if dtype == BF16:
        ok = (ok and res["max_row_excess"] <= 0.0
              and res["rel_norm_err"] <= FLASH_REL_TOL)
    assert ok, res
    return res, (q, k, v)


def time_flash(fa, q, k, v, window, cap, peak_bw):
    """ms, plain_ms, bound_ms, bound_by, TFLOP/s, the share of the bound
    and the SDPA yardstick (causal, no softcap, no window: windowed shapes
    get null)."""
    b, t, h, dh = q.shape
    out = fa.flash_attention(q, k, v, window=window, softcap=cap)
    rate = PEAK_BF16_OPS_PER_S if q.dtype == BF16 else PEAK_FP32_OPS_PER_S
    ops = 4 * b * h * dh * visible_pairs(t, window)
    bnd, by = bound(nbytes(q, k, v, out), ops, peak_bw, rate)
    iters = 20 if t <= 1024 else 5
    lib = None
    if not window:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, window=window,
                                            softcap=cap), iters)
    return dict(
        ms=ms,
        plain_ms=time_ms(lambda: fa.flash_attention_plain(
            q, k, v, window=window, softcap=cap), 3),
        bound_ms=bnd, bound_by=by, library_ms=lib, flops=ops,
        tflops_per_s=ops / ms / 1e9, bound_share=bnd / ms,
        shape=[b, t, h, k.shape[2], dh], window=window, softcap=cap)


def serve_prompts(rng, lo: int, hi: int, vocab: int):
    """SERVE_BATCH prompts with lengths drawn from [lo, hi), the longest
    set to exactly hi."""
    lens = rng.integers(lo, hi, SERVE_BATCH)
    lens[int(np.argmax(lens))] = hi
    return [rng.integers(1, vocab, int(n)).tolist() for n in lens]


class StepRecord:
    """``ServeEngine.run``'s ``on_step`` hook: the logits of every step and
    the host-clock ms of each, per batch. The engine has read a step's
    tokens back to the host before it calls the hook, so each interval
    ends on a finished step and the hook adds no synchronisation. A
    prefill's ms run from the end of the step before it (or the start of
    the run): batch assembly, cache allocation, prefill, first token."""

    def __init__(self):
        self.logits, self.prefill_ms, self.decode_ms = [], [], []
        self.t = time.perf_counter()

    def __call__(self, step, logits):
        now = time.perf_counter()
        ms, self.t = (now - self.t) * 1e3, now
        if step == 0:
            self.prefill_ms.append(ms)
            self.decode_ms.append([])
        else:
            self.decode_ms[-1].append(ms)
        self.logits.append(logits)


def serve_run(cfg, params, batches, temperature=0.0, generator=None,
              max_new=SERVE_NEW, record=True):
    """One engine run over the batches; (requests, StepRecord or None, wall
    seconds)."""
    from repro_torch.serving import Request, ServeEngine
    eng = ServeEngine(cfg, params, max_batch=SERVE_BATCH, max_seq=SERVE_SEQ,
                      temperature=temperature)
    for batch in batches:
        for p in batch:
            eng.submit(Request(prompt=p, max_new_tokens=max_new))
    torch.cuda.synchronize()
    rec = StepRecord() if record else None
    t0 = time.perf_counter()
    done = eng.run(generator, on_step=rec)
    torch.cuda.synchronize()
    return done, rec, time.perf_counter() - t0


def check_requests(done, batches, vocab, max_new=SERVE_NEW):
    assert len(done) == sum(len(b) for b in batches), len(done)
    for r in done:
        assert len(r.out_tokens) == max_new, (len(r.prompt), r.out_tokens)
        assert all(0 <= t < vocab for t in r.out_tokens), r.out_tokens


def batch_stats(done, rec, batches):
    """Prefill ms, decode ms per step and tokens/s of each batch of one
    recorded run (tokens over prefill + decode time)."""
    out = []
    for i, (batch, name) in enumerate(zip(batches, "AB")):
        steps = rec.decode_ms[i]
        tokens = sum(len(r.out_tokens)
                     for r in done[SERVE_BATCH * i:SERVE_BATCH * (i + 1)])
        busy_ms = rec.prefill_ms[i] + sum(steps)
        out.append({
            "batch": name, "prompt_lens": [len(p) for p in batch],
            "prefill_ms": rec.prefill_ms[i], "decode_steps": len(steps),
            "decode_ms_per_step": sum(steps) / len(steps),
            "decode_ms_min": min(steps), "decode_ms_max": max(steps),
            "tokens": tokens, "tokens_per_s": tokens / busy_ms * 1e3})
    return out


def profile_serve(cfg, params, prompts, max_new):
    """torch.profiler over one engine run (one prefill and max_new - 1
    decode steps): wall, device time, busy share, kernel launches, the
    flash kernel's device time per launch, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_run(cfg, params, [prompts], max_new=max_new, record=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    flash = [e for e in kernels if re.search(FLASH_SYMBOL, e.key)]
    n_flash = sum(e.count for e in flash)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"decode_steps": max_new - 1, "wall_ms": wall_us / 1e3,
            "device_ms": device_us / 1e3,
            "device_busy_share": device_us / wall_us,
            "kernel_launches": sum(e.count for e in kernels),
            "flash_launches": n_flash,
            "flash_device_ms_per_launch": (
                sum(e.self_device_time_total for e in flash) / n_flash / 1e3
                if n_flash else None),
            "top_kernels": [(e.key[:60], e.count,
                             e.self_device_time_total / 1e3) for e in top]}


def prefill_decode_consistency(cfg, params, dev, dtype: str, b=2, t=640,
                               t_pre=512, frontend=None):
    """Logits of a kernel prefill of t tokens against a kernel prefill of
    t_pre plus t - t_pre teacher-forced decode steps (plain sdpa over the
    cache): (max |Δ|, max |logit|, flash launches). An encoder-decoder or
    frontend model's ``frontend`` (b, F, d) rides in both prefills; a
    frontend model's decode positions start after its F."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import decode_step, forward, init_cache
    c = cfg.replace(dtype=dtype)
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(1, c.vocab_size, (b, t))).to(dev)
    fe = {} if frontend is None else {"frontend": frontend}
    f = 0 if frontend is None else frontend.shape[1]
    off = 0 if c.encdec else f
    fa.reset_launches()
    full, _, _ = forward(c, params, {"tokens": toks, **fe})
    want = full[:, t_pre:].clone()
    del full
    cache = init_cache(c, b, off + t, dev, enc_len=f if c.encdec else 0)
    _, cache, _ = forward(c, params, {"tokens": toks[:, :t_pre], **fe},
                          cache=cache)
    err = 0.0
    for i in range(t - t_pre):
        lg, cache = decode_step(c, params, toks[:, t_pre + i:t_pre + i + 1],
                                off + t_pre + i, cache)
        err = max(err, float((lg[:, 0] - want[:, i]).abs().max()))
    torch.cuda.synchronize()
    return err, float(want.abs().max()), fa.LAUNCHES["flash_attention"]


def run_serve_path(dev, smi, fa):
    """gemma2-2b at full width through ServeEngine: two greedy runs of
    batches A and B (launches counted over the first), a sampled run,
    profiles, the consistency check. Returns the flash launches of the
    path and the profile of batch B's prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_lm
    cfg = get_config(GEMMA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _ = init_lm(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(int(v.numel()) for v in params.values())
    emit({"phase": "serve_init", "arch": GEMMA, "params": n_params,
          "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED)
    batch_a = serve_prompts(rng, 64, 512, cfg.vocab_size)
    batch_b = serve_prompts(rng, 1000, 4608, cfg.vocab_size)
    batches = [batch_a, batch_b]

    # the main path: counts from 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    done, rec, wall = serve_run(cfg, params, batches)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    check_requests(done, batches, cfg.vocab_size)
    assert launches == 2 * cfg.n_layers, launches
    assert all(bool(torch.isfinite(x).all()) for x in rec.logits)
    emit({"phase": "serve", "arch": GEMMA, "run": "greedy_1",
          "max_batch": SERVE_BATCH, "max_seq": SERVE_SEQ,
          "max_new_tokens": SERVE_NEW, "flash_launches": launches,
          "requests": len(done), "wall_s": wall,
          "tokens_per_s": sum(len(r.out_tokens) for r in done) / wall,
          "peak_memory_bytes": peak,
          "batches": batch_stats(done, rec, batches),
          "tokens": [r.out_tokens for r in done], "nvidia_smi": smi})

    done2, rec2, wall2 = serve_run(cfg, params, batches)
    check_requests(done2, batches, cfg.vocab_size)
    same_tokens = ([r.out_tokens for r in done2]
                   == [r.out_tokens for r in done])
    logit_diff = max(float((a - b).abs().max())
                     for a, b in zip(rec.logits, rec2.logits))
    emit({"phase": "serve", "arch": GEMMA, "run": "greedy_2",
          "wall_s": wall2,
          "tokens_per_s": sum(len(r.out_tokens) for r in done2) / wall2,
          "batches": batch_stats(done2, rec2, batches),
          "same_tokens": same_tokens,
          "max_abs_logit_diff_vs_run_1": logit_diff,
          "logit_steps_compared": len(rec.logits)})
    assert same_tokens and logit_diff == 0.0, (same_tokens, logit_diff)
    del rec, rec2

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    done3, _, wall3 = serve_run(cfg, params, [batch_a], temperature=0.8,
                                generator=gen)
    check_requests(done3, [batch_a], cfg.vocab_size)
    emit({"phase": "serve", "arch": GEMMA, "run": "temperature_0.8",
          "batch": "A", "wall_s": wall3,
          "tokens": [r.out_tokens for r in done3],
          "differs_from_greedy": [r.out_tokens for r in done3]
          != [r.out_tokens for r in done[:4]]})

    profiles = {}
    for name, prompts, max_new in (("A_prefill", batch_a, 1),
                                   ("A_prefill_8_decode", batch_a, 9),
                                   ("B_prefill", batch_b, 1)):
        profiles[name] = profile_serve(cfg, params, prompts, max_new)
    pa, pad = profiles["A_prefill"], profiles["A_prefill_8_decode"]
    emit({"phase": "serve_profile", "arch": GEMMA, "nvidia_smi": smi,
          "decode_launches_per_step":
              (pad["kernel_launches"] - pa["kernel_launches"]) / 8,
          "decode_device_ms_per_step":
              (pad["device_ms"] - pa["device_ms"]) / 8,
          **profiles})

    for dtype in ("float32", "bfloat16"):
        err, scale, n = prefill_decode_consistency(cfg, params, dev, dtype)
        emit({"phase": "prefill_decode_consistency", "arch": GEMMA,
              "dtype": dtype, "prefill": 640, "split": 512,
              "decode_steps": 128, "max_abs_diff": err,
              "max_abs_logit": scale, "rel": err / scale,
              "flash_launches": n})
        assert n == 2 * cfg.n_layers, n
        if dtype == "float32":
            assert err <= CONSIST_TOL * scale, (err, scale)
    del params
    torch.cuda.empty_cache()
    return launches, profiles["B_prefill"]


def run_serve_cli(fa):
    """``python -m repro_torch.launch.serve --arch gemma2-2b --full``, in
    this process: 8 requests of 4-24 tokens (the plain prefill branch)."""
    from repro_torch.launch import serve
    fa.reset_launches()
    t0 = time.perf_counter()
    done = serve.main(["--arch", GEMMA, "--full"])
    torch.cuda.synchronize()
    row = {"phase": "serve_cli", "argv": ["--arch", GEMMA, "--full"],
           "requests": len(done), "seconds": time.perf_counter() - t0,
           "tokens": [len(r.out_tokens) for r in done],
           "flash_launches": fa.LAUNCHES["flash_attention"]}
    emit(row)
    assert len(done) == 8 and all(n == 12 for n in row["tokens"]), row
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7 (run before path 1): the kernels' public API (kernels/ops.py)
# ---------------------------------------------------------------------------

# (d, d_pad): the exchange bench size, 2^25 (2,048 blocks of 128 x 128),
# bench_kernels.py's rotate_10M (611 blocks) and the paper's MLP
OPS_SIZES = ((BENCH_M * BENCH_D, BENCH_M * BENCH_D), (10_000_000, 10_010_624),
             (D_MLP, 32_768))
OPS_BITS = (4, 8, 12, 16)
# the JAX test's Hadamard shapes, the largest block (8 CTAs of 4,096),
# blocks under 8 coordinates and a block of one row
HADAMARD_SHAPES = [(1, 128, 128), (3, 128, 128), (4, 64, 64), (2, 128, 64),
                   (7, 16, 16), (4, 256, 128), (5, 2, 2), (3, 1, 4),
                   (2, 1, 8192)]
LATTICE_TEST_CASES = [(1024, 4), (8192, 8), (4096, 12), (65536, 8)]
OPS_GAMMA = 0.02                  # the JAX test's lattice step
OPS_SYMBOLS = {"hadamard_blocks": "hadamard_cluster_kernel",
               "lattice_encode": "lattice_enc_kernel",
               "lattice_decode": "lattice_dec_kernel"}


def ops_checks(hd, lq, dev, gen):
    """Each kernel of the API against its plain version, torch.equal:
    hadamard_blocks on fp32 and bf16 input at the JAX test's shapes, at
    rc = 32,768 and at the three sizes as (n, 128, 128); lattice_encode and
    lattice_decode at bits 4-16 on y straddling 0 (γ where y/γ spans the
    ring twice) at the three sizes and the JAX test's (d, bits), γ on the
    device and as a number. Returns the largest |Δ| of each kernel."""
    err = {k: 0.0 for k in OPS_SYMBOLS}
    for shape in HADAMARD_SHAPES + [(dp // 16_384, 128, 128)
                                    for _, dp in OPS_SIZES]:
        x = torch.randn(shape, generator=gen, device=dev)
        for dtype in (FP32, BF16):
            out = hd.hadamard_blocks(x.to(dtype))
            want = hd.hadamard_plain(x.to(dtype))
            res = {"kernel": "hadamard_blocks", "shape": list(shape),
                   "dtype": str(dtype).split(".")[1],
                   "max_abs_err": float((out - want).abs().max()),
                   "equal": torch.equal(out, want)}
            emit({"phase": "ops_check", **res})
            assert res["equal"], res
            err["hadamard_blocks"] = max(err["hadamard_blocks"],
                                         res["max_abs_err"])
        del x, out, want
    cases = ([(dp, bits) for _, dp in OPS_SIZES for bits in OPS_BITS]
             + LATTICE_TEST_CASES)
    for d, bits in cases:
        y = torch.randn(d, generator=gen, device=dev)
        u = torch.rand(d, generator=gen, device=dev)
        g = float(y.abs().max()) / (1 << bits) / 2
        g_dev = torch.tensor(g, device=dev)
        w = y + 0.1 * g * torch.randn(d, generator=gen, device=dev)
        codes = lq.lattice_encode(y, u, g_dev, bits=bits)
        want_c = lq.lattice_encode_plain(y, u, g, bits=bits)
        out = lq.lattice_decode(codes, w, g_dev, bits=bits)
        want_o = lq.lattice_decode_plain(codes, w, g, bits=bits)
        res = {"kernel": "lattice_encode+lattice_decode", "d": d,
               "bits": bits, "gamma": g,
               "encode_max_abs_err": float((codes - want_c).abs().max()),
               "encode_equal": torch.equal(codes, want_c),
               "encode_gamma_number_equal": torch.equal(
                   codes, lq.lattice_encode(y, u, g, bits=bits)),
               "decode_max_abs_err": float((out - want_o).abs().max()),
               "decode_equal": torch.equal(out, want_o),
               "decode_gamma_number_equal": torch.equal(
                   out, lq.lattice_decode(codes, w, g, bits=bits)),
               "codes_min_max": [int(codes.min()), int(codes.max())]}
        emit({"phase": "ops_check", **res})
        assert (res["encode_equal"] and res["decode_equal"]
                and res["encode_gamma_number_equal"]
                and res["decode_gamma_number_equal"]), res
        err["lattice_encode"] = max(err["lattice_encode"],
                                    res["encode_max_abs_err"])
        err["lattice_decode"] = max(err["lattice_decode"],
                                    res["decode_max_abs_err"])
    torch.cuda.synchronize()
    return err


def run_ops_path(ops, kx, dev, gen):
    """The API as a user calls it, at each size: rotate a flat vector
    (rotate_blocks), rotate it back, encode the rotated coordinates at 8
    bits with γ = 0.02 on the device (lattice_encode), decode them against
    w = y + 0.001·N(0,1) (lattice_decode) and inverse-rotate the decode.
    Each rotation is held to fused_rotate bit for bit, the round trip to
    ROT_TOL, the decode to 1.001·γ (the JAX test's check)."""
    from repro_torch.compression.rotation import signs
    g_dev = torch.tensor(OPS_GAMMA, device=dev)
    rows = []
    for d, d_pad in OPS_SIZES:
        x = torch.randn(d, generator=gen, device=dev)
        sg = signs(gen, d_pad)
        y = ops.rotate_blocks(x, sg)
        back = ops.rotate_blocks(y, sg, inverse=True)[:d]
        u = torch.rand(d_pad, generator=gen, device=dev)
        codes = ops.lattice_encode(y, u, g_dev)
        w = y + 0.001 * torch.randn(d_pad, generator=gen, device=dev)
        x_hat = ops.lattice_decode(codes, w, g_dev)
        x_out = ops.rotate_blocks(x_hat, sg, inverse=True)
        x_pad = torch.nn.functional.pad(x, (0, d_pad - d))[None]
        res = {"d": d, "d_pad": d_pad, "blocks": d_pad // 16_384,
               "rotate_equals_fused_rotate": torch.equal(
                   y, kx.fused_rotate(x_pad, sg)[0]),
               "inverse_equals_fused_rotate": torch.equal(
                   x_out, kx.fused_rotate(x_hat[None], sg, inverse=True)[0]),
               "round_trip_rel_err": float((back - x).abs().max()
                                           / x.abs().max()),
               "decode_max_err_over_gamma": float((x_hat - y).abs().max())
               / OPS_GAMMA,
               "decoded_vs_x_max": float((x_out[:d] - x).abs().max()),
               "finite": bool(torch.isfinite(x_out).all())}
        rows.append(res)
        emit({"phase": "ops", **res})
        assert (res["rotate_equals_fused_rotate"]
                and res["inverse_equals_fused_rotate"] and res["finite"]), res
        assert res["round_trip_rel_err"] <= ROT_TOL, res
        assert res["decode_max_err_over_gamma"] <= 1.001, res
        del x, y, back, u, codes, w, x_hat, x_out, x_pad
    torch.cuda.synchronize()
    return rows


def time_ops(hd, lq, dev, gen, peak_bw):
    """ms, plain_ms, bound_ms, bound_by, library_ms and device_ms of the
    three kernels at 2^25 coordinates (2,048 blocks of 128 x 128), and of
    hadamard_blocks on bf16 input; the yardstick of hadamard_blocks is one
    fp32 einsum with H_128 on both sides, TF32 off."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.compression.rotation import hadamard_matrix
    n = BENCH_M * BENCH_D
    x = torch.randn((n // 16_384, 128, 128), generator=gen, device=dev)
    xb = x.to(BF16)
    h = hd.hadamard_blocks(x)
    y = h.reshape(-1)
    u = torch.rand(n, generator=gen, device=dev)
    g = torch.tensor(OPS_GAMMA, device=dev)
    codes = lq.lattice_encode(y, u, g)
    w = y + 0.001 * torch.randn(n, generator=gen, device=dev)
    x_hat = lq.lattice_decode(codes, w, g)
    h128 = torch.from_numpy(hadamard_matrix(128)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    h_ops = n * (int(math.log2(16_384)) + 1)     # the stages' adds, scale
    calls = {
        "hadamard_blocks": (lambda: hd.hadamard_blocks(x),
                            lambda: hd.hadamard_plain(x),
                            bound(nbytes(x, h), h_ops, peak_bw),
                            lambda: torch.einsum("ij,bjk,kl->bil", h128, x,
                                                 h128)),
        "hadamard_blocks_bf16": (lambda: hd.hadamard_blocks(xb),
                                 lambda: hd.hadamard_plain(xb),
                                 bound(nbytes(xb, h), h_ops, peak_bw), None),
        "lattice_encode": (lambda: lq.lattice_encode(y, u, g),
                           lambda: lq.lattice_encode_plain(y, u, g),
                           bound(nbytes(y, u, g, codes), n * QUANTIZE_OPS,
                                 peak_bw), None),
        "lattice_decode": (lambda: lq.lattice_decode(codes, w, g),
                           lambda: lq.lattice_decode_plain(codes, w, g),
                           bound(nbytes(codes, w, g, x_hat), n * SNAP_OPS,
                                 peak_bw), None)}
    out = {}
    for name, (kernel, plain, (b_ms, b_by), lib) in calls.items():
        out[name] = dict(ms=time_ms(kernel), plain_ms=time_ms(plain, 5),
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=time_ms(lib) if lib else None,
                         shape=[n])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name in OPS_SYMBOLS:
            for _ in range(5):
                calls[name][0]()
        torch.cuda.synchronize()
    for name, ms in ms_per_launch(device_events(prof), OPS_SYMBOLS).items():
        out[name]["device_ms"] = ms
    out["hadamard_blocks_bf16"]["device_ms"] = kernel_device_ms(
        calls["hadamard_blocks_bf16"][0], OPS_SYMBOLS["hadamard_blocks"], 5)
    for name in ("hadamard_blocks", "hadamard_blocks_bf16"):
        out[name]["launch"] = hd.launch_geometry(*x.shape)
    return out


# ---------------------------------------------------------------------------
# phase 8: federated LM training through launch/train.py — llama3.2-1b at
# full width in a process of its own (the card's memory to itself), then
# every registry algorithm at reduced width
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "llama3.2-1b", "--algo", "quafl", "--bits", "8",
              "--n-slots", "2", "--batch", "8", "--seq", "128",
              "--local-steps", "2", "--lr", "0.02", "--steps", "5",
              "--log-every", "1", "--seed", "0", "--kernel-backend", "cuda"]
LLAMA_D, LLAMA_D_PAD = 1_235_814_400, 1_235_828_736
MAMBA_D, MAMBA_D_PAD = 368_338_432, 368_345_088     # mamba2-370m (--zoo)
TRAIN_S = 2
# bits a round by d_pad: s uplink messages and one downlink, d_pad·8 + 32
# each
TRAIN_BITS = {LLAMA_D_PAD: (19_773_259_840, 9_886_629_920),
              MAMBA_D_PAD: (5_893_521_472, 2_946_760_736)}
# a round's port launches: the fused uplink encode, the server's forward
# rotation, the server's and the clients' inverse rotations, the downlink
# quantize, and the uplink and downlink snaps with their averages
TRAIN_LAUNCHES = {"fused_encode": 1, "fused_rotate": 3, "quantize_codes": 1,
                  "snap_codes": 0, "fused_decode": 0, "uplink": 1,
                  "average": 1}
TRAIN_PREFIX = 1 << 24            # 1,024 whole blocks of 16,384
# the fused uplink's rel_err and hint_srv against the plain version's
# (sums of squares per warp, per CTA and over CTAs; torch another way)
FUSED_STAT_TOL = 1e-5
TRAIN_TIMED = 3                   # rounds timed alone after the run
TRAIN_FULL_TIMEOUT = 600          # seconds for the full-width process
REDUCED_ARGV = ["--arch", "llama3.2-1b", "--reduced", "--batch", "4",
                "--seq", "64", "--log-every", "1", "--lr", "0.05",
                "--algo", "quafl"]
TRAIN_ALGOS = ("quafl", "fedavg", "compressed_fedavg", "fedbuff",
               "fedbuff_device", "sequential", "quafl_scaffold",
               "adaptive_quafl")


def lattice_bits(d_pad: int, bits: int = 8) -> int:
    return d_pad * bits + 32


def train_bytes(d_pad: int, s: int = TRAIN_S) -> dict:
    """Bytes a round of each exchange kernel must move at (s, d_pad):
    inputs read once, outputs written once. Encode: x, u, y, int32 codes
    and the sign row; rotations: the server forward and inverse (1 row)
    and the clients' inverse (s rows), 8 a coordinate, and the sign row
    each; quantize: y, u, codes; uplink: s code rows and s rows of Y,
    the server in and its average out; average: one code row, s rows read
    and written."""
    return {"fused_encode": (16 * s + 4) * d_pad,
            "fused_rotate": (8 * (2 + s) + 12) * d_pad,
            "quantize_codes": 12 * d_pad,
            "uplink": (8 * s + 8) * d_pad,
            "average": (8 * s + 4) * d_pad}


def recording_ops(ops, log: list):
    """The pipeline's backend with every call's inputs and outputs cut to
    their first TRAIN_PREFIX coordinates (whole blocks: each block rotates
    on its own) and kept in ``log`` as (op, args, kwargs, out)."""
    def head(x):
        if isinstance(x, tuple):
            return tuple(head(v) for v in x)
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() and x.shape[-1] > TRAIN_PREFIX:
            return x[..., :TRAIN_PREFIX].clone()
        return x.clone()

    def wrap(name, fn):
        def call(*args, **kw):
            # the inputs before the call: ``average`` writes into its rows
            ins = ([head(a) for a in args],
                   {k: head(v) for k, v in kw.items()})
            out = fn(*args, **kw)
            log.append((name, *ins, head(out)))
            return out
        return call

    return ops._replace(**{f: wrap(f, getattr(ops, f))
                           for f in ("rotate", "encode", "quantize",
                                     "snap", "decode", "uplink",
                                     "average")})


def check_train_prefixes(kx, log) -> dict:
    """Each recorded launch of the round against its plain version on the
    same prefix and the round's own γ: rotations within ROT_TOL of max|y|,
    codes within ±1 mod L at rounding boundaries (counted), snaps within
    DECODE_TOL of max|x| (the uplink's server average; its rel_err and
    hint_srv are of the whole rows, not of the prefix)."""
    plain = {"rotate": kx.rotate_plain, "encode": kx.encode_plain,
             "quantize": kx.quantize_plain, "snap": kx.snap_plain,
             "decode": kx.decode_plain, "uplink": kx.uplink_plain,
             "average": kx.average_plain}
    out = []
    for name, args, kw, got in log:
        want = plain[name](*args, **kw)
        if name == "uplink":
            got, want = got[0], want[0]
        row = {"op": name, "shape": list(args[0].shape)}
        if name == "encode":
            codes, codes_w = got, want
            if isinstance(got, tuple):
                (y, codes), (y_w, codes_w) = got, want
                row["rel_err"] = float((y - y_w).abs().max()
                                       / y_w.abs().max())
                assert row["rel_err"] <= ROT_TOL, row
            gap = code_gap(codes, codes_w, 1 << kw["bits"])
            row.update(code_mismatches=int((gap > 0).sum()),
                       max_gap=int(gap.max()))
        elif name == "quantize":
            gap = code_gap(got, want, 1 << kw["bits"])
            row.update(code_mismatches=int((gap > 0).sum()),
                       max_gap=int(gap.max()))
        else:
            tol = ROT_TOL if name == "rotate" else DECODE_TOL
            row["rel_err"] = float((got - want).abs().max()
                                   / want.abs().max())
            assert row["rel_err"] <= tol, row
        if "max_gap" in row:
            assert row["max_gap"] <= 1, row
            assert row["code_mismatches"] <= (ENC_MISMATCH_FRAC
                                              * got_numel(got)), row
        out.append(row)
    return out


def check_summary(rows) -> dict:
    """Per op: calls checked, the largest relative error, the ±1 code
    mismatches."""
    out = {}
    for r in rows:
        o = out.setdefault(r["op"], {"calls": 0, "max_rel_err": 0.0,
                                     "code_mismatches": 0})
        o["calls"] += 1
        o["max_rel_err"] = max(o["max_rel_err"], r.get("rel_err", 0.0))
        o["code_mismatches"] += r.get("code_mismatches", 0)
    return out


def got_numel(got) -> int:
    return (got[1] if isinstance(got, tuple) else got).numel()


def time_train_kernels(kx, dev, peak_bw, d_pad) -> dict:
    """ms a call (CUDA events, host overhead included) of the round's
    wrappers at the training round's shapes, on random inputs: the encode
    of s messages with y kept, the inverse rotation of s rows and the
    forward rotation of one, the downlink quantize, the fused uplink (s
    code rows against one server row, the server average out: 8·s + 8 B a
    coordinate) and the fused average (one code row against s rows,
    written in place: 8·s + 4 B a coordinate), each beside its byte
    bound."""
    from repro_torch.compression.rotation import signs
    s = TRAIN_S
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    x = torch.randn((s, d_pad), generator=g, device=dev)
    sg = signs(g, d_pad)
    u = torch.rand((s, d_pad), generator=g, device=dev)
    gam = torch.full((s,), 0.01, device=dev)
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True)
    x1, u1, g1 = x[:1], u[:1], gam[:1].contiguous()
    y1, c1 = y[:1], codes[:1]
    calls = {
        "fused_encode": (lambda: kx.fused_encode(x, sg, u, gam,
                                                 want_rotated=True),
                         nbytes(x, u, y, codes) + nbytes(sg), [s, d_pad]),
        "fused_rotate": (lambda: kx.fused_rotate(x, sg, inverse=True),
                         2 * nbytes(x) + nbytes(sg), [s, d_pad]),
        "fused_rotate_1": (lambda: kx.fused_rotate(x1, sg),
                           2 * nbytes(x1) + nbytes(sg), [1, d_pad]),
        "quantize_codes": (lambda: kx.quantize_codes(y1, u1, g1),
                           nbytes(y1, u1, c1), [1, d_pad]),
        "uplink": (lambda: kx.uplink(codes, y1, y, gam),
                   nbytes(codes, y, y1) + nbytes(y1), [s, d_pad]),
        # last: it writes the rows it reads
        "average": (lambda: kx.average(c1, y, g1),
                    nbytes(c1) + 2 * nbytes(y), [s, d_pad])}
    out = {}
    for name, (fn, nb, shape) in calls.items():
        out[name] = {"ms": time_ms(fn, 5), "bound_ms": nb / peak_bw * 1e3,
                     "bound_by": "bytes", "bytes": nb, "shape": shape}
        torch.cuda.empty_cache()
    return out


def check_train_fused(kx, dev, d_pad) -> dict:
    """The fused uplink and average at the training round's full (s, d_pad)
    against their plain versions, on rows made as a round makes them: the
    clients' rows near the server row, the clients' codes at γ_up and the
    server's at γ_dn, each γ from the rows' largest gap. The server
    average and the clients' average bit for bit; rel_err and hint_srv,
    which the prefix check cannot see (they are of the whole rows), within
    FUSED_STAT_TOL relative. Peak about 12 rows of d_pad floats."""
    s = TRAIN_S
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    srv = torch.randn((1, d_pad), generator=g, device=dev)
    y = torch.randn((s, d_pad), generator=g, device=dev).mul_(0.1).add_(srv)
    gap = (y - srv).abs_().amax(dim=1)
    gam_up = (gap * 4 / 256).contiguous()
    gam_dn = (gap.amax() * 4 / 256).reshape(1)
    u = torch.rand((s, d_pad), generator=g, device=dev)
    codes = kx.quantize_codes(y, u, gam_up)
    del u
    got = kx.uplink(codes, srv, y, gam_up)
    want = kx.uplink_plain(codes, srv, y, gam_up)
    torch.cuda.synchronize()
    row = {"shape": [s, d_pad], "uplink_average_equal":
           bool(torch.equal(got[0], want[0]))}
    for i, k in ((1, "rel_err"), (2, "hint_srv")):
        row[k] = [float(got[i]), float(want[i])]
        row[k + "_rel"] = abs(row[k][0] - row[k][1]) / abs(row[k][1])
    del codes, got, want
    torch.cuda.empty_cache()
    u = torch.rand((1, d_pad), generator=g, device=dev)
    c_dn = kx.quantize_codes(srv, u, gam_dn)
    del u, srv
    mine = kx.average(c_dn, y.clone(), gam_dn)
    row["average_equal"] = bool(torch.equal(
        mine, kx.average_plain(c_dn, y, gam_dn)))
    del mine, y, c_dn
    torch.cuda.empty_cache()
    assert row["uplink_average_equal"] and row["average_equal"], row
    assert row["rel_err_rel"] <= FUSED_STAT_TOL, row
    assert row["hint_srv_rel"] <= FUSED_STAT_TOL, row
    return row


def train_full(argv=TRAIN_ARGV, d=LLAMA_D, d_pad=LLAMA_D_PAD,
               phase="train_full") -> int:
    """The full-width phase, run as ``chip_smoke.py --train-full`` in its
    own process (llama3.2-1b; mamba2-370m in ``--zoo``): five QuAFL rounds
    through ``launch/train.py`` (counts from 0 just before, read just
    after), then one profiled round and one round whose kernel launches are
    held against their plain versions on a 2^24-coordinate prefix; with
    the model freed, the wrappers timed and the fused uplink and average
    held against their plain versions at the full (s, d_pad)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import exchange as kx
    from repro_torch.launch import train

    from repro_torch import default_device
    from repro_torch.compression.rotation import pad_len

    smi = smi_line()
    peak_bw = peak_bytes_per_s(torch.cuda.get_device_name(0))
    args = train.parse_args(argv)
    dev = default_device(args.device)
    cfg = get_config(args.arch)
    fed = train.fed_config(args)
    kx.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.run_registry(args, cfg, fed, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kx.LAUNCHES)
    peak_run = torch.cuda.max_memory_allocated()
    alg, tr, data = run.alg, run.trace, run.data
    assert alg.d == d and pad_len(alg.d) == d_pad, alg.d
    up, down = TRAIN_BITS[d_pad]
    assert (up, down) == (TRAIN_S * lattice_bits(d_pad), lattice_bits(d_pad))
    for r in tr.rows:
        assert r["bits_up"] == up and r["bits_down"] == down, r
        assert r["bits_up_total"] == up * r["round"], r
        assert math.isfinite(r["server_loss"]) and math.isfinite(
            r["quant_err"]), r
    state = tr.final_state
    assert float(state.bits_up) == up * tr.rounds
    assert float(state.bits_down) == down * tr.rounds
    assert launches == {k: v * tr.rounds for k, v in
                        TRAIN_LAUNCHES.items()}, launches

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    (state, m), wall, kernels = profiled(
        lambda: alg.round(state, data, gen))
    peak_round = torch.cuda.max_memory_allocated()
    assert math.isfinite(float(m["quant_err"]))
    per_round = port_launches(kernels)
    assert per_round == TRAIN_LAUNCHES, per_round
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_launch = ms_per_launch(kernels, KERNEL_SYMBOLS)
    nb = train_bytes(d_pad)
    kernel_rows = {}
    for k, b in nb.items():
        n = TRAIN_LAUNCHES[k]
        kernel_rows[k] = {"launches_a_round": n,
                          "device_ms_per_launch": per_launch[k],
                          "device_ms_a_round": per_launch[k] * n,
                          "bound_ms_a_round": b / peak_bw * 1e3,
                          "bound_ms_per_launch": b / peak_bw * 1e3 / n,
                          "bytes_a_round": b}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    # ms a round, synchronised, with no eval and no profiler
    walls = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = alg.round(state, data, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)

    log = []
    alg.pipeline.ops = recording_ops(alg.pipeline.ops, log)
    state, m = alg.round(state, data, gen)
    torch.cuda.synchronize()
    alg.pipeline.ops = alg.pipeline.ops._replace(
        **{f: getattr(kx, n) for f, n in (("rotate", "fused_rotate"),
                                          ("encode", "fused_encode"),
                                          ("quantize", "quantize_codes"),
                                          ("snap", "snap_codes"),
                                          ("uplink", "uplink"),
                                          ("average", "average"))})
    checks = check_train_prefixes(kx, log)
    res = {"phase": phase, "arch": cfg.name, "d": alg.d,
          "d_pad": d_pad, "n_clients": fed.n_clients, "s": fed.s,
          "bits": fed.bits, "batch": args.batch, "seq": args.seq,
          "local_steps": fed.local_steps, "rounds": tr.rounds,
          "server_loss": [r["server_loss"] for r in tr.rows],
          "quant_err": [r["quant_err"] for r in tr.rows],
          "bits_up_a_round": up, "bits_down_a_round": down,
          "ms_per_round": tr.us_per_round / 1e3,
          "row_wall_s": [r["wall_time_s"] for r in tr.rows],
          "timed_round_ms": walls,
          "seconds_with_init": seconds,
          "peak_bytes_run": peak_run, "peak_bytes_round": peak_round,
          "peak_model_copies": peak_run / (4 * d_pad),
          "device_bytes_total": torch.cuda.mem_get_info()[1],
          "launches": launches, "launches_a_round": per_round,
          "profiled_round_wall_ms": wall * 1e3,
          "device_ms_a_round": device_ms,
          "device_launches_a_round": sum(e.count for e in kernels),
          "device_busy_share": device_ms / (wall * 1e3),
          "top_kernels": [(e.key[:70], e.count,
                           e.self_device_time_total / 1e3) for e in top],
          "kernels": kernel_rows, "prefix_checks": checks,
          "nvidia_smi": smi}
    # the model's state is no longer needed: the card's memory goes to the
    # wrappers' timing at the round's shapes
    del log, state, m, run, tr, alg, data
    torch.cuda.empty_cache()
    res["kernel_times"] = time_train_kernels(kx, dev, peak_bw, d_pad)
    torch.cuda.empty_cache()
    res["fused_checks"] = check_train_fused(kx, dev, d_pad)
    emit(res)
    return 0


def bits_a_round(name, d, row) -> tuple:
    """The exact bits up and down of one reduced-width round at n = s = 2,
    b = 8 (an adaptive width of b <= 8 rides 8-bit codes)."""
    from repro_torch.compression.rotation import pad_len
    width = int(row.get("bits_width", 8))
    msg = lattice_bits(pad_len(d), 8 if width <= 8 else 16)
    full = 32 * d
    return {"quafl": (2 * msg, msg), "adaptive_quafl": (2 * msg, msg),
            "quafl_scaffold": (4 * msg, 2 * msg),
            "fedavg": (2 * full, 2 * full),
            "compressed_fedavg": (2 * lattice_bits(pad_len(d)), full),
            "fedbuff": (2 * full, 2 * full),
            "fedbuff_device": (2 * full, 2 * full),
            "sequential": (0, 0)}[name]


def run_train_reduced(kx) -> dict:
    """Every registry algorithm two rounds of reduced llama3.2-1b through
    ``launch/train.py`` on the card (counts from 0 just before, read just
    after), bits exact; a ``--scan-chunk 2`` QuAFL run against its eager
    run; a checkpoint saved and restored."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_size
    kx.reset_launches()
    runs = {}
    for name in TRAIN_ALGOS:
        run = train.main(REDUCED_ARGV + ["--steps", "2", "--algo", name])
        d = tree_size(run.alg.eval_params(run.trace.final_state))
        for r in run.trace.rows:
            assert (r["bits_up"], r["bits_down"]) == bits_a_round(
                name, d, r), (name, r)
            assert math.isfinite(r["server_loss"]), (name, r)
        runs[name] = [r["server_loss"] for r in run.trace.rows]
    torch.cuda.synchronize()
    launches = dict(kx.LAUNCHES)
    emit({"phase": "launches", "path": "train_reduced",
          "launches": launches})
    for k in ("fused_encode", "fused_rotate", "quantize_codes", "uplink",
              "average", "fused_decode"):
        assert launches[k] > 0, f"kernel {k} never launched on training"

    eager = train.main(REDUCED_ARGV + ["--steps", "4"])
    chunked = train.main(REDUCED_ARGV + ["--steps", "4", "--scan-chunk",
                                         "2"])
    assert chunked.trace.engine == "scanned"
    for a, b in zip(eager.trace.rows, chunked.trace.rows):
        for k in ("bits_up", "bits_down", "sim_time"):
            assert a[k] == b[k], (k, a, b)
    unequal = int((eager.trace.final_state.server
                   != chunked.trace.final_state.server).sum())
    assert unequal == 0, unequal

    ckdir = ROOT / "build" / "train_ckpt"
    run = train.main(REDUCED_ARGV + ["--steps", "2", "--checkpoint-dir",
                                     str(ckdir)])
    params = run.alg.eval_params(run.trace.final_state)
    back = restore_checkpoint(str(ckdir), 2, params)
    assert all(torch.equal(back[k], params[k]) for k in params)
    res = {"phase": "train_reduced", "server_loss": runs,
           "scan_chunk_unequal": unequal,
           "scan_chunk_us_per_round": chunked.trace.us_per_round,
           "eager_us_per_round": eager.trace.us_per_round,
           "checkpoint_leaves": len(params)}
    emit(res)
    return res


def run_train_full() -> None:
    """``chip_smoke.py --train-full`` in a process of its own, so that the
    model has the card's memory to itself; its lines relayed. (The
    allocator's expandable segments fit the same peak but made a round
    519-1,007 ms against 470-492 without them, measured on one H100.)"""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--train-full"], capture_output=True, text=True,
                          timeout=TRAIN_FULL_TIMEOUT)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the full-width train phase exited "
                           f"{proc.returncode}")


# ---------------------------------------------------------------------------
# path 10: the mesh train step (spmd) on an NCCL process group of one rank
# ---------------------------------------------------------------------------

SPMD_ARGV = ["--arch", "llama3.2-1b", "--batch", "8", "--seq", "128",
             "--local-steps", "2", "--lr", "0.02", "--steps", "5",
             "--log-every", "1", "--seed", "0", "--kernel-backend", "cuda"]
# one uplink message and the downlink broadcast of the 11 leaves, each
# padded on its own (n_slots = 1; dequant_psum charges no extra)
SPMD_BITS = 9_886_515_552
SPMD_LEAVES = 11
# launches a leaf: the whole-leaf family's uplink and downlink encodes and
# decodes; the shard-local exchange's 2 encodes, 3 rotations and 2 snaps
SPMD_LAUNCHES = {"fused_encode": 2, "fused_rotate": 0, "quantize_codes": 0,
                 "snap_codes": 0, "fused_decode": 2, "uplink": 0,
                 "average": 0}
SHARD_LOCAL_LAUNCHES = {"fused_encode": 2, "fused_rotate": 3,
                        "quantize_codes": 0, "snap_codes": 2,
                        "fused_decode": 0, "uplink": 0, "average": 0}
SPMD_TIMED = 3
SPMD_TIMEOUT = 600                # seconds for the spmd process
SPMD_REDUCED = ["--arch", "llama3.2-1b", "--reduced", "--batch", "4",
                "--seq", "64", "--local-steps", "2", "--lr", "0.05",
                "--seed", "0"]
SPMD_TRANSPORTS = ("dequant_psum", "code_allgather", "shard_local",
                   "shard_local_codes", "shard_local_rs")
SPMD_ROUNDS = 3
EMBED_D_PAD, SCATTER_SHARDS = 262_668_288, 4     # embed/tok, 128,256 × 2,048


def nccl_group_of_one() -> None:
    """An NCCL process group of one rank on the card, from an in-memory
    store (no port)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)


def nccl_kernels(kernels) -> dict:
    """Launches of NCCL's kernels among the device events."""
    return {e.key[:60]: e.count for e in kernels if "nccl" in e.key.lower()}


def spmd_full(smi, kx, argv=SPMD_ARGV, bits=SPMD_BITS, leaves=SPMD_LEAVES,
              d=LLAMA_D, phase="spmd_full") -> dict:
    """Five rounds of ``launch/train.py``'s defaults (``--algo spmd
    --transport dequant_psum``) at full width (llama3.2-1b; mamba2-370m in
    ``--zoo``) over the NCCL group of one (counts from 0 just before, read
    just after), bits exact; a profiled round, rounds timed alone, then a
    round of each family with every launch held against its plain version
    on its first TRAIN_PREFIX coordinates: the whole-leaf round, and one
    with ``--transport shard_local`` on the same state."""
    from repro_torch.compression import pipeline
    from repro_torch.configs import get_config
    from repro_torch.fed import make_algorithm
    from repro_torch.launch import train
    from repro_torch.models.model import lm_loss
    args = train.parse_args(argv)
    assert (args.algo, args.transport) == ("spmd", "dequant_psum")
    cfg = get_config(args.arch)
    dev = torch.device("cuda", 0)
    kx.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.run_registry(args, cfg, train.fed_config(args), device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kx.LAUNCHES)
    peak_run = torch.cuda.max_memory_allocated()
    alg, tr, data = run.alg, run.trace, run.data
    state, tr.final_state = tr.final_state, None
    del run
    assert alg.mesh.distributed and alg.n_slots == 1, alg.mesh
    assert alg._bits_up_msg == alg._bits_down_msg == bits
    for r in tr.rows:
        assert r["bits_up"] == bits and r["bits_down"] == bits, r
        assert math.isfinite(r["server_loss"]), r
    assert float(state.bits_up) == float(state.bits_down) == \
        bits * tr.rounds
    want = {k: v * leaves * tr.rounds for k, v in SPMD_LAUNCHES.items()}
    assert launches == want, (launches, want)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    (state, m), wall, kernels = profiled(
        lambda: alg.round(state, data, gen))
    peak_round = torch.cuda.max_memory_allocated()
    per_round = port_launches(kernels)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    walls = []
    for _ in range(SPMD_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = alg.round(state, data, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)

    # a round of each family with every launch recorded on its first
    # TRAIN_PREFIX coordinates (whole blocks) and held against the plain
    # versions: the whole-leaf round, then one of the shard-local exchange
    # on the same state (its pipeline takes the recording backend when
    # built)
    cuda_ops, log = pipeline._REGISTRY["cuda"], []
    pipeline._REGISTRY["cuda"] = recording_ops(cuda_ops, log)
    try:
        state, _ = alg.round(state, data, gen)
        torch.cuda.synchronize()
        checks = check_train_prefixes(kx, log)
        log.clear()
        fed_sl = dataclasses.replace(alg.fed, transport="shard_local")
        sl = make_algorithm("spmd", fed_sl, loss_fn=None,
                            template=alg.template, cfg=cfg, mesh=alg.mesh,
                            batch=args.batch, seq=args.seq, device=dev)
        kx.reset_launches()
        state, m_sl = sl.round(state, data, gen)
        torch.cuda.synchronize()
        sl_launches = dict(kx.LAUNCHES)
        sl_checks = check_train_prefixes(kx, log)
    finally:
        pipeline._REGISTRY["cuda"] = cuda_ops
    del log
    ops_of = {"fused_encode": "encode", "fused_rotate": "rotate",
              "snap_codes": "snap", "fused_decode": "decode"}
    for rows, per_leaf in ((checks, SPMD_LAUNCHES),
                           (sl_checks, SHARD_LOCAL_LAUNCHES)):
        got = check_summary(rows)
        assert {op: got[op]["calls"] for op in got} == {
            ops_of[k]: n * leaves for k, n in per_leaf.items() if n}, got
    assert sl_launches == {k: v * leaves for k, v in
                           SHARD_LOCAL_LAUNCHES.items()}, sl_launches
    assert m_sl["bits_up"] == m_sl["bits_down"] == bits
    with torch.no_grad():
        loss_sl = float(lm_loss(cfg, sl.eval_params(state),
                                {"tokens": data["tokens"][0, :args.batch]})[0])
    assert math.isfinite(loss_sl) and math.isfinite(float(m_sl["quant_err"]))
    v_bytes = 4 * d
    res = {"phase": phase, "arch": cfg.name,
           "mesh": dict(alg.mesh.shape),
           "backend": "nccl", "world_size": 1, "transport": args.transport,
           "d": d, "n_slots": alg.n_slots, "batch": args.batch,
           "seq": args.seq, "local_steps": args.local_steps,
           "rounds": tr.rounds,
           "server_loss": [r["server_loss"] for r in tr.rows],
           "quant_err": [r["quant_err"] for r in tr.rows],
           "bits_up_a_round": bits, "bits_down_a_round": bits,
           "launches": launches, "launches_a_round_profiled": per_round,
           "ms_per_round": tr.us_per_round / 1e3,
           "row_wall_s": [r["wall_time_s"] for r in tr.rows],
           "timed_round_ms": walls, "seconds_with_init": seconds,
           "profiled_round_wall_ms": wall * 1e3,
           "device_ms_a_round": device_ms,
           "device_launches_a_round": sum(e.count for e in kernels),
           "device_busy_share": device_ms / (wall * 1e3),
           "nccl_kernels_a_round": nccl_kernels(kernels),
           "peak_bytes_run": peak_run, "peak_bytes_round": peak_round,
           "peak_model_copies": peak_run / v_bytes,
           "top_kernels": [(e.key[:70], e.count,
                            e.self_device_time_total / 1e3) for e in top],
           "shard_local": {"launches": sl_launches, "loss": loss_sl,
                           "quant_err": float(m_sl["quant_err"])},
           "prefix_checks": {"dequant_psum": check_summary(checks),
                             "shard_local": check_summary(sl_checks)},
           "nvidia_smi": smi}
    emit(res)
    return res


def spmd_states_equal(a, b) -> int:
    """Unequal elements between two spmd states' servers and clients."""
    n = 0
    for part in ("server", "clients"):
        x, y = getattr(a.train, part), getattr(b.train, part)
        n += sum(int((x[k] != y[k]).sum()) for k in x)
    return n


def spmd_reduced(smi, kx) -> dict:
    """Reduced llama3.2-1b: each transport on the local (1, 1) mesh and on
    the NCCL group of one, bit-equal (servers, clients, metrics), NCCL's
    kernels counted in a profiled round; ``simulate(scan_chunk=2)`` against
    the eager run on the NCCL mesh, bit for bit (the collectives captured
    in the chunk's graph); ``scatter_encode_gather`` at embed/tok's padded
    length in 4 shards on the kernels against the plain versions."""
    from repro_torch.compression.pipeline import ExchangePipeline, LatticeWire
    from repro_torch.compression.transports import scatter_encode_gather
    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import federated_token_task
    from repro_torch.fed import make_algorithm, simulate
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.models.model import init_lm
    args = train.parse_args(SPMD_REDUCED)
    cfg = get_reduced(args.arch)
    dev = torch.device("cuda", 0)
    meshes = {"local": Mesh((1, 1), ("data", "model")),
              "nccl": make_mesh((1, 1), ("data", "model"))}
    assert meshes["nccl"].distributed and not meshes["local"].distributed
    p0, _ = init_lm(cfg, seed=0, device=dev)
    data, _ = federated_token_task(0, 1, 64, args.batch, args.seq,
                                   cfg.vocab_size, device=dev)
    out = {"phase": "spmd", "arch": cfg.name + " (reduced)",
           "transports": {}, "nvidia_smi": smi}
    kx.reset_launches()
    for tr_name in SPMD_TRANSPORTS:
        fed = dataclasses.replace(train.fed_config(args), n_clients=1, s=1,
                                  transport=tr_name)
        runs = {}
        for label, mesh in meshes.items():
            alg = make_algorithm("spmd", fed, loss_fn=None, template=p0,
                                 cfg=cfg, mesh=mesh, batch=args.batch,
                                 seq=args.seq, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            st, ms = alg.init(p0), []
            for _ in range(SPMD_ROUNDS):
                st, m = alg.round(st, data, gen)
                ms.append({k: float(v) for k, v in m.items()})
            runs[label] = (alg, st, ms)
        unequal = spmd_states_equal(runs["local"][1], runs["nccl"][1])
        assert unequal == 0, (tr_name, unequal)
        assert runs["local"][2] == runs["nccl"][2], tr_name
        alg, st, _ = runs["nccl"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(8)
        _, wall, kernels = profiled(lambda: alg.round(st, data, gen))
        out["transports"][tr_name] = {
            "unequal": unequal, "metrics": runs["nccl"][2][-1],
            "nccl_kernels_a_round": nccl_kernels(kernels),
            "port_launches_a_round": port_launches(kernels),
            "profiled_round_wall_ms": wall * 1e3}
    torch.cuda.synchronize()
    out["launches"] = dict(kx.LAUNCHES)

    # chunked against eager on the NCCL mesh: the collectives inside the
    # captured graph
    out["chunked"] = {}
    for tr_name in ("dequant_psum", "shard_local_codes"):
        fed = dataclasses.replace(train.fed_config(args), n_clients=1, s=1,
                                  transport=tr_name)
        traces = {}
        for chunk in (0, 2):
            alg = make_algorithm("spmd", fed, loss_fn=None, template=p0,
                                 cfg=cfg, mesh=meshes["nccl"],
                                 batch=args.batch, seq=args.seq, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(9)
            traces[chunk] = simulate(alg, p0, data, gen, rounds=4,
                                     eval_every=0, record_every=1,
                                     scan_chunk=chunk)
        assert traces[2].engine == "scanned"
        for key in ("bits_up", "bits_down", "sim_time", "quant_err",
                    "h_steps_mean"):
            assert traces[0].column(key) == traces[2].column(key), key
        unequal = spmd_states_equal(traces[0].final_state,
                                    traces[2].final_state)
        assert unequal == 0, (tr_name, unequal)
        out["chunked"][tr_name] = {
            "unequal": unequal,
            "us_per_round_eager": traces[0].us_per_round,
            "us_per_round_chunked": traces[2].us_per_round,
            "graph_times": round_graph_times(alg)}

    # the fused reduce-scatter's redistribution at embed/tok's padded
    # length, 4 shards: quantize_codes then snap_codes on the kernels
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    vec = torch.randn((1, EMBED_D_PAD), generator=g, device=dev)
    ref = vec + 0.01 * torch.randn((1, EMBED_D_PAD), generator=g, device=dev)
    u = torch.rand((SCATTER_SHARDS, EMBED_D_PAD // SCATTER_SHARDS),
                   generator=g, device=dev)
    gam = torch.full((1,), 0.002, device=dev)
    wire = LatticeWire(bits=8)
    pipes = {b: ExchangePipeline(bits=8, backend=b)
             for b in ("cuda", "torch")}
    kx.reset_launches()
    dec, codes = scatter_encode_gather(pipes["cuda"], wire, vec, ref, gam, u,
                                       SCATTER_SHARDS)
    torch.cuda.synchronize()
    sc_launches = dict(kx.LAUNCHES)
    assert sc_launches["quantize_codes"] == 1 and \
        sc_launches["snap_codes"] == 1, sc_launches
    dec_p, codes_p = scatter_encode_gather(pipes["torch"], wire, vec, ref,
                                           gam, u, SCATTER_SHARDS)
    code_unequal = int((codes != codes_p).sum())
    dec_unequal = int((dec != dec_p).sum())
    assert code_unequal == 0 and dec_unequal == 0, (code_unequal,
                                                    dec_unequal)
    del dec_p, codes_p, dec, codes
    torch.cuda.empty_cache()
    ms = {b: time_ms(lambda b=b: scatter_encode_gather(
        pipes[b], wire, vec, ref, gam, u, SCATTER_SHARDS), 5)
        for b in ("cuda", "torch")}
    out["scatter_encode_gather"] = {
        "d_pad": EMBED_D_PAD, "shards": SCATTER_SHARDS,
        "launches": sc_launches, "code_unequal": code_unequal,
        "decode_unequal": dec_unequal, "ms": ms["cuda"],
        "plain_ms": ms["torch"]}
    emit(out)
    return out


def round_graph_times(alg) -> dict:
    from repro_torch.fed.simulate import round_engine
    return round_engine(alg).graph_times()


def spmd_phases() -> int:
    """``chip_smoke.py --spmd``, in a process of its own: the NCCL group
    of one, then ``spmd_full`` and ``spmd`` (each path's counts from 0
    just before, read just after)."""
    import torch.distributed as dist
    from repro_torch.kernels import exchange as kx
    smi = smi_line()
    nccl_group_of_one()
    try:
        spmd_full(smi, kx)
        torch.cuda.empty_cache()
        spmd_reduced(smi, kx)
    finally:
        dist.destroy_process_group()
    return 0


def run_spmd() -> None:
    """``chip_smoke.py --spmd`` in a process of its own, its lines
    relayed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--spmd"], capture_output=True, text=True,
                          timeout=SPMD_TIMEOUT)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the spmd phases exited {proc.returncode}")
    emit({"phase": "spmd_process", "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# path 11: the rest of the decoder zoo (Mamba2, MoE, MLA, hybrid) at
# published widths, in a process of its own
# ---------------------------------------------------------------------------

MAMBA = "mamba2-370m"
MAMBA_TRAIN_ARGV = ["--arch", MAMBA] + TRAIN_ARGV[2:]
MAMBA_SPMD_ARGV = ["--arch", MAMBA] + SPMD_ARGV[2:]
MAMBA_SPMD_BITS = 2_946_818_400   # 11 leaves, each padded on its own
MAMBA_LEAVES = 11
ZOO_TIMEOUT = 900                 # seconds for the zoo process
# (arch, depth on the card: 0 the whole model, "reduced" the reduced
# config; the serve batches). Depth is cut where a whole model would not
# fit: deepseek to the dense MLA prefix layer and one MLA-MoE layer,
# llama4 to one iRoPE period (3 chunked + 1 global NoPE), jamba (one
# 8-layer period at published widths holds 45.1 B params) to its reduced
# config.
ZOO_SERVE = ((MAMBA, 0, "AB"), ("gemma3-12b", 0, "A"),
             ("deepseek-v2-236b", 2, "A"), ("llama4-scout-17b-a16e", 4, "A"),
             ("jamba-1.5-large-398b", "reduced", "AB"))
JAMBA_ARGV = ["--arch", "jamba-1.5-large-398b", "--reduced", "--batch", "4",
              "--seq", "64", "--log-every", "1", "--lr", "0.05", "--steps",
              "2", "--algo", "quafl"]


def flash_layers(cfg) -> int:
    """Layers whose prefill takes the flash kernel (t % 128 == 0):
    attention that is neither chunked nor MLA, at a head dim the kernel
    takes."""
    from repro_torch.configs.base import (ATTN_FULL, ATTN_SLIDING,
                                          KIND_ATTN)
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    specs = list(cfg.prefix) + list(cfg.schedule) * cfg.n_periods
    return sum(s.kind == KIND_ATTN and s.attn in (ATTN_FULL, ATTN_SLIDING)
               and cfg.head_dim in HEAD_DIMS for s in specs)


def zoo_serve(smi, dev, arch, depth, names) -> dict:
    """One arch of the zoo through ``ServeEngine`` (counts from 0 just
    before, read just after): greedy batches, run twice and identical,
    every prefill's flash launches, an MoE arch's grouped products (every
    MoE layer of every prefill and decode step), the peak memory, ms and
    the profiled device ms of batch A's prefill and 8 decode steps (an MoE
    arch's beside those of the host-read routing), then the fp32
    prefill/decode consistency."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_mm as gm
    from repro_torch.models.model import init_lm
    cfg = get_reduced(arch) if depth == "reduced" else get_config(arch)
    reduced = {"reduced": ["width and depth: the reduced config"]}.get(
        depth, [])
    if depth and depth != "reduced":
        reduced = [f"depth: {depth} of {cfg.n_layers} layers"]
        cfg = cfg.replace(n_layers=depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = init_lm(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(v.numel()) for v in params.values())
    rng = np.random.default_rng(SEED)
    batch_a = serve_prompts(rng, 64, 512, cfg.vocab_size)
    batch_b = serve_prompts(rng, 1000, 4608, cfg.vocab_size)
    batches = [batch_a, batch_b][:len(names)]
    n_flash = flash_layers(cfg)

    # the path: counts from 0 just before, read just after
    fa.reset_launches()
    gm.reset_launches()
    done, rec, wall = serve_run(cfg, params, batches)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    grouped = dict(gm.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_requests(done, batches, cfg.vocab_size)
    assert launches == len(batches) * n_flash, (arch, launches)
    assert (grouped["grouped_mm_fwd"] > 0) == (cfg.moe is not None) \
        and grouped["grouped_mm_dgrad"] == grouped["grouped_mm_wgrad"] == 0, \
        (arch, grouped)
    assert all(bool(torch.isfinite(x).all()) for x in rec.logits), arch
    done2, rec2, wall2 = serve_run(cfg, params, batches)
    same_tokens = ([r.out_tokens for r in done2]
                   == [r.out_tokens for r in done])
    logit_diff = max(float((a - b).abs().max())
                     for a, b in zip(rec.logits, rec2.logits))
    assert same_tokens and logit_diff == 0.0, (arch, same_tokens,
                                               logit_diff)
    stats = batch_stats(done, rec, batches)
    stats_2 = batch_stats(done2, rec2, batches)
    del rec, rec2
    prof = profile_serve(cfg, params, batch_a, 9)
    err, scale, n = prefill_decode_consistency(cfg, params, dev, "float32")
    assert n == 2 * n_flash, (arch, n)
    assert err <= CONSIST_TOL * scale, (arch, err, scale)
    res = {"phase": "zoo_serve", "arch": arch, "reduced": reduced,
           "n_layers": cfg.n_layers, "params": n_params,
           "init_seconds": init_s, "flash_layers": n_flash,
           "flash_launches": launches, "grouped_launches": grouped,
           "requests": len(done),
           "wall_s": [wall, wall2], "peak_memory_bytes": peak,
           "batches": stats, "batches_run_2": stats_2,
           "same_tokens": same_tokens,
           "max_abs_logit_diff_vs_run_1": logit_diff,
           "profile_A_prefill_8_decode": prof,
           "consistency_fp32": {"prefill": 640, "split": 512,
                                "max_abs_diff": err, "max_abs_logit": scale,
                                "rel": err / scale, "flash_launches": n},
           "tokens": [r.out_tokens for r in done], "nvidia_smi": smi}
    emit(res)
    del params
    torch.cuda.empty_cache()
    return res


def zoo_jamba_rounds(kx) -> dict:
    """Two QuAFL rounds of reduced jamba (Mamba, attention and MoE layers)
    through ``launch/train.py`` on the card (counts from 0 just before,
    read just after), bits exact."""
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_size
    kx.reset_launches()
    run = train.main(JAMBA_ARGV)
    torch.cuda.synchronize()
    launches = dict(kx.LAUNCHES)
    d = tree_size(run.alg.eval_params(run.trace.final_state))
    for r in run.trace.rows:
        assert (r["bits_up"], r["bits_down"]) == bits_a_round("quafl", d, r)
        assert math.isfinite(r["server_loss"]), r
    assert launches == {k: 2 * v for k, v in TRAIN_LAUNCHES.items()}, \
        launches
    res = {"phase": "zoo_train_reduced", "arch": "jamba-1.5-large-398b",
           "reduced": ["width and depth: the reduced config"], "d": d,
           "server_loss": [r["server_loss"] for r in run.trace.rows],
           "launches": launches}
    emit(res)
    return res


def zoo_phases() -> int:
    """``chip_smoke.py --zoo``, in a process of its own: mamba2-370m at
    full width through the registry's QuAFL and the mesh train step (an
    NCCL group of one), then each arch of ``ZOO_SERVE`` served, then two
    QuAFL rounds of reduced jamba (each path's counts from 0 just before,
    read just after)."""
    import torch.distributed as dist
    from repro_torch.kernels import exchange as kx
    smi = smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    train_full(MAMBA_TRAIN_ARGV, MAMBA_D, MAMBA_D_PAD, "zoo_train_full")
    torch.cuda.empty_cache()
    nccl_group_of_one()
    try:
        spmd_full(smi, kx, MAMBA_SPMD_ARGV, MAMBA_SPMD_BITS, MAMBA_LEAVES,
                  MAMBA_D, "zoo_spmd_full")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    for arch, depth, names in ZOO_SERVE:
        zoo_serve(smi, dev, arch, depth, names)
    zoo_jamba_rounds(kx)
    emit({"phase": "zoo", "seconds": time.perf_counter() - t0})
    return 0


def run_zoo() -> None:
    """``chip_smoke.py --zoo`` in a process of its own (the card's memory
    to itself), its lines relayed."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--zoo"], capture_output=True, text=True,
                          timeout=ZOO_TIMEOUT)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the zoo phases exited {proc.returncode}")


# ---------------------------------------------------------------------------
# path 12: the population store split across ranks, and the mesh serving
# steps, in a process of its own over an NCCL group of one
# ---------------------------------------------------------------------------

POP_TIMEOUT = 900                 # seconds for the population process
POP_CHUNK = 10                    # rounds a captured chunk
# (registry name, kwargs) of the one-round whole-vs-split checks at n=300
POP_ONE_ROUND = (
    ("quafl_scaffold", {"uplink": "lattice"}),
    ("compressed_fedavg", {}),
    ("fedbuff_device", {"quantize": True, "quantizer": "lattice",
                        "buffer_size": FEDBUFF_Z}))
POP_SCALE_N = (1_000, 100_000)
POP_SCALE_S = 8
POP_SCALE_ROUNDS = 100            # each run: 10 chunks of 10 rounds
POP_SCALE_FLOOR_MS = 0.2          # the reference's floor (200 us a round)
POP_SCALE_RATIO = 1.5             # tests/test_population.py:509-525
MESH_SERVE_STEPS = 32


def pop_state_rows(state) -> dict:
    """Every row of an algorithm state's store, whole (split rows
    all-gathered), and the names of the split ones."""
    from repro_torch.fed.population import SplitRow, whole_row
    pop = (state.base if hasattr(state, "base") else state).pop
    return ({k: whole_row(v) for k, v in pop.rows.items()
             if not isinstance(v, tuple)},
            sorted(k for k, v in pop.rows.items()
                   if isinstance(v, SplitRow)))


def pop_run(dev, name, cm, rounds, chunk, kw):
    """Two runs at the paper's cell on the whole store (``cm`` None) or
    split over ``cm``, from the same seed (the second replays the first's
    captured chunks): (alg, trace, server, rows, split names, launches
    counted from 0 just before the first and read just after it, wall s
    of each run). The two runs must agree bit for bit."""
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import simulate
    from repro_torch.kernels import exchange as kx
    from repro_torch.models.mlp import mlp_loss_batched
    from repro_torch.utils.tree import tree_flatten_vector
    fed, part, _, p0, gen0 = chip_world(dev)
    extra = dict(kw, client_mesh=cm) if cm is not None else dict(kw)
    alg = make_algorithm(name, fed, loss_fn=mlp_loss_batched, template=p0,
                         batch_size=32, device=dev, **extra)
    walls, servers = [], []
    for i in range(2):
        gen = torch.Generator(device=dev)
        gen.set_state(gen0.get_state())
        torch.cuda.synchronize()
        if i == 0:
            kx.reset_launches()
        t0 = time.perf_counter()
        tr = simulate(alg, p0, part, gen, rounds=rounds, eval_every=0,
                      record_every=1, scan_chunk=chunk)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kx.LAUNCHES)
        servers.append(tree_flatten_vector(alg.eval_params(tr.final_state)))
    assert torch.equal(servers[0], servers[1]), name
    rows, split = pop_state_rows(tr.final_state)
    return alg, tr, servers[1], rows, split, launches, walls


def population_phase(smi, dev) -> dict:
    """QuAFL at the paper's cell (784-32-10, n=300, s=16, K=5, b=8, seed
    0) for 30 rounds in captured 10-round chunks, on a store split over
    client_mesh() (the NCCL group of one) and on the whole store: bits
    exact every round, servers and every row bit-equal; then one round of
    SCAFFOLD, compressed FedAvg and FedBuffDevice the same way."""
    from repro_torch.fed import client_mesh
    mesh = client_mesh()
    assert mesh.distributed and dict(mesh.shape) == {"clients": 1}
    runs = {}
    for label, cm in (("whole", None), ("split", mesh)):
        runs[label] = pop_run(dev, "quafl", cm, ROUNDS, POP_CHUNK,
                              {"uplink": "lattice"})
    _, trw, sw, rw, _, lw, ww = runs["whole"]
    alg, trs, ss, rs, split, ls, ws = runs["split"]
    assert trs.engine == trw.engine == "scanned"
    assert trs.column("bits_up") == [4_194_816] * ROUNDS, \
        trs.column("bits_up")
    assert trs.column("bits_down") == [BITS_DOWN] * ROUNDS
    for key in ("bits_up", "bits_down", "sim_time"):
        assert trs.column(key) == trw.column(key), key
    assert torch.equal(ss, sw)
    assert rs.keys() == rw.keys()
    assert all(torch.equal(rs[k], v) for k, v in rw.items())
    assert split == ["group", "last_time", "model"], split
    for k in ("fused_encode", "fused_rotate", "quantize_codes", "uplink",
              "average"):
        assert ls[k] > 0, f"kernel {k} never launched on the split store"
    assert ls == lw, (ls, lw)
    res = {"phase": "population", "algorithm": "quafl", "n_clients": N_CLIENTS,
           "s": S, "rounds": ROUNDS, "chunk": POP_CHUNK,
           "mesh": dict(mesh.shape), "backend": "nccl", "split_rows": split,
           "bits_up": trs.column("bits_up")[0],
           "bits_down": trs.column("bits_down")[0],
           "server_equal_whole": True, "rows_equal_whole": sorted(rw),
           "launches": ls,
           "ms_per_round_split": [w / ROUNDS * 1e3 for w in ws],
           "ms_per_round_whole": [w / ROUNDS * 1e3 for w in ww],
           "graph_times_split": round_graph_times(alg), "one_round": {},
           "nvidia_smi": smi}
    del runs
    for name, kw in POP_ONE_ROUND:
        one = {}
        for label, cm in (("whole", None), ("split", mesh)):
            one[label] = pop_run(dev, name, cm, 1, 0, kw)
        _, trw, sw, rw, _, lw, _ = one["whole"]
        _, trs, ss, rs, split, ls, _ = one["split"]
        for key in ("bits_up", "bits_down", "sim_time"):
            assert trs.column(key) == trw.column(key), (name, key)
        assert torch.equal(ss, sw), name
        assert all(torch.equal(rs[k], v) for k, v in rw.items()), name
        assert ls == lw and (ls["fused_encode"] or ls["fused_decode"]), \
            (name, ls, lw)
        res["one_round"][name] = {"split_rows": split, "launches": ls,
                                  "bits_up": trs.column("bits_up")[0],
                                  "bits_down": trs.column("bits_down")[0]}
        del one
    emit(res)
    return res


def scale_world(dev, n):
    """QuAFL at 784-32-10 over n clients, s=8, split over client_mesh():
    every client reads one client's data pool (an expanded view, no
    memory that grows with n)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_mlp import dims
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.fed import client_mesh
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched
    d_in, d_hidden, n_cls = dims()
    fed = FedConfig(n_clients=n, s=POP_SCALE_S, local_steps=K, lr=LR,
                    bits=8, swt=SWT, kernel_backend="cuda")
    part, _ = make_federated_classification(SEED, 1, d=d_in,
                                            n_classes=n_cls, device=dev)
    data = {k: v.expand((n,) + tuple(v.shape[1:])) for k, v in part.items()}
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    p0 = init_mlp_classifier(g, d_in, d_hidden, n_cls)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched,
                         template=p0, batch_size=32, device=dev,
                         client_mesh=client_mesh())
    return alg, p0, data


def recorded_chunk(kx, alg, state, data, dev) -> dict:
    """One more captured chunk of ``alg`` from ``state`` on an engine of
    its own, with its pipeline's backend recording every call
    (``recording_ops``: the calls of the warm-up round and of the capture,
    their recorded tensors refreshed by the chunk's replay), launches
    counted from 0 just before and read just after. Every recorded call
    is held against its plain version on the same inputs
    (``check_train_prefixes``), and the checked calls must be exactly the
    launches."""
    from repro_torch.fed.engine import RoundEngine
    ops0, log = alg.pipeline.ops, []
    alg.pipeline.ops = recording_ops(ops0, log)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    try:
        kx.reset_launches()
        RoundEngine(alg).run_chunk(state, data, g, POP_CHUNK)
        torch.cuda.synchronize()
        launches = dict(kx.LAUNCHES)
    finally:
        alg.pipeline.ops = ops0
    rows = check_train_prefixes(kx, log)
    got = check_summary(rows)
    ops_of = {"fused_encode": "encode", "fused_rotate": "rotate",
              "quantize_codes": "quantize", "snap_codes": "snap",
              "fused_decode": "decode", "uplink": "uplink",
              "average": "average"}
    assert {op: got[op]["calls"] for op in got} == {
        ops_of[k]: v for k, v in launches.items() if v}, (got, launches)
    return {"launches": launches, "checks": got,
            "shapes": sorted({(r["op"], tuple(r["shape"])) for r in rows})}


def population_scale_phase(smi, dev) -> dict:
    """The split-store QuAFL at n = 10^3 and 10^5, s = 8, in captured
    10-round chunks: ms a round of a second run (the first captures) at
    10^5 within 1.5x of 10^3 (floor 0.2 ms), the store's bytes and the
    peak memory; then, at 10^5, one more chunk whose every kernel call is
    held against its plain version (``recorded_chunk``)."""
    from repro_torch.fed.simulate import simulate
    from repro_torch.kernels import exchange as kx
    out = {}
    for n in POP_SCALE_N:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        alg, p0, data = scale_world(dev, n)
        kx.reset_launches()
        ms = []
        for _ in range(2):
            g = torch.Generator(device=dev)
            g.manual_seed(SEED)
            torch.cuda.synchronize()
            tr = simulate(alg, p0, data, g, rounds=POP_SCALE_ROUNDS,
                          eval_every=0, scan_chunk=POP_CHUNK)
            torch.cuda.synchronize()
            assert tr.engine == "scanned" and tr.rounds == POP_SCALE_ROUNDS
            ms.append(tr.us_per_round / 1e3)
        launches = dict(kx.LAUNCHES)
        for k in ("fused_encode", "fused_rotate", "quantize_codes",
                  "uplink", "average"):
            assert launches[k] > 0, (n, k)
        pop = tr.final_state.pop
        store = sum(int(v.store.numel()) * v.store.element_size()
                    if hasattr(v, "store") else
                    (int(v.numel()) * v.element_size()
                     if isinstance(v, torch.Tensor) else 0)
                    for v in pop.rows.values())
        assert math.isfinite(float(tr.final["quant_err"]))
        out[n] = {"ms_per_round_runs": ms, "ms_per_round": ms[1],
                  "store_bytes": store,
                  "model_row_bytes": n * alg.d * 4,
                  "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                  "launches_first_run": launches,
                  "graph_times": round_graph_times(alg)}
        if n == POP_SCALE_N[-1]:
            out[n]["kernel_checks"] = recorded_chunk(
                kx, alg, tr.final_state, data, dev)
        del alg, tr, pop
    base = max(out[POP_SCALE_N[0]]["ms_per_round"], POP_SCALE_FLOOR_MS)
    ratio = out[POP_SCALE_N[1]]["ms_per_round"] / base
    res = {"phase": "population_scale", "algorithm": "quafl", "s": POP_SCALE_S,
           "chunk": POP_CHUNK, "rounds": POP_SCALE_ROUNDS,
           "by_n": {str(n): v for n, v in out.items()},
           "ratio_vs_floor_1e3": ratio, "limit": POP_SCALE_RATIO,
           "n_1e6_model_row_bytes": 1_000_000 * D_MLP * 4,
           "nvidia_smi": smi}
    emit(res)
    assert ratio < POP_SCALE_RATIO, res
    return res


def mesh_serve_phase(smi, dev, mesh) -> dict:
    """gemma2-2b at full width on batch A through build_prefill_step and
    MESH_SERVE_STEPS build_serve_step calls on ``mesh`` (counts from 0
    just before the prefill, read just after): one flash launch a layer,
    the last-position logits against ServeEngine's prefill, greedy tokens
    identical to ServeEngine's on the same prompts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, rank_blocks)
    from repro_torch.models.model import init_lm
    cfg = get_config(GEMMA)
    params, _ = init_lm(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    batch_a = serve_prompts(rng, 64, 512, cfg.vocab_size)
    done, rec, _ = serve_run(cfg, params, [batch_a])
    want_tokens = [r.out_tokens for r in done]
    want_logits = rec.logits[0]
    del rec
    plen = max(len(p) for p in batch_a)
    toks = torch.zeros((len(batch_a), plen), dtype=torch.int64)
    for i, p in enumerate(batch_a):   # left-padded with 0, as the engine
        toks[i, plen - len(p):] = torch.tensor(p, dtype=torch.int64)
    toks = toks.to(dev)
    pre_shape = ShapeConfig("serve_A", SERVE_SEQ, SERVE_BATCH, "prefill")
    dec_shape = ShapeConfig("serve_A", SERVE_SEQ, SERVE_BATCH, "decode")
    prefill, _, (p_specs, b_specs) = build_prefill_step(cfg, mesh,
                                                        pre_shape)
    step, _, _, (_, c_specs, t_spec, _) = build_serve_step(cfg, mesh,
                                                           dec_shape)
    blocks = rank_blocks(params, p_specs, mesh)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path: counts from 0 just before, read just after
    fa.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(blocks, rank_blocks({"tokens": toks}, b_specs,
                                                mesh))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = fa.LAUNCHES["flash_attention"]
    assert launches == flash_layers(cfg) == cfg.n_layers, launches
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    got = [tok]
    step_ms = []
    for i in range(MESH_SERVE_STEPS):
        t0 = time.perf_counter()
        tok, cache = step(blocks, cache, tok, plen + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got.append(tok)
    tokens = torch.cat(got, 1)[:, :SERVE_NEW].tolist()
    diff = float((logits - want_logits).abs().max())
    scale = float(want_logits.abs().max())
    res = {"phase": "mesh_serve", "arch": GEMMA, "mesh": dict(mesh.shape),
           "backend": "nccl", "prompt_lens": [len(p) for p in batch_a],
           "cache_seq": SERVE_SEQ, "flash_launches_prefill": launches,
           "serve_steps": MESH_SERVE_STEPS, "prefill_ms": prefill_ms,
           "serve_step_ms_mean": sum(step_ms) / len(step_ms),
           "serve_step_ms_min": min(step_ms),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "logits_max_abs_diff_vs_engine": diff, "max_abs_logit": scale,
           "same_tokens_as_engine": tokens == want_tokens,
           "nvidia_smi": smi}
    emit(res)
    assert all(bool(torch.isfinite(x).all()) for x in (logits,))
    assert diff <= CONSIST_TOL * scale, res
    assert tokens == want_tokens, (tokens, want_tokens)
    return res


def population_phases() -> int:
    """``chip_smoke.py --population``, in a process of its own: the NCCL
    group of one, then ``population``, ``population_scale`` and
    ``mesh_serve`` (each path's counts from 0 just before, read just
    after)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    smi = smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    nccl_group_of_one()
    try:
        population_phase(smi, dev)
        torch.cuda.empty_cache()
        population_scale_phase(smi, dev)
        torch.cuda.empty_cache()
        mesh_serve_phase(smi, dev, make_mesh((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()
    emit({"phase": "population_process", "seconds":
          time.perf_counter() - t0})
    return 0


def run_population() -> None:
    """``chip_smoke.py --population`` in a process of its own, its lines
    relayed."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--population"], capture_output=True, text=True,
                          timeout=POP_TIMEOUT)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the population phases exited "
                           f"{proc.returncode}")


# ---------------------------------------------------------------------------
# path 13: the encoder-decoder and frontend archs through the mesh prefill,
# serve and train steps, in a process of its own over an NCCL group of one
# ---------------------------------------------------------------------------

SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
ENCDEC_TIMEOUT = 600              # seconds for the encdec process
ENCDEC_BATCH, ENCDEC_STEPS = 4, 16
# seamless: 512 text tokens a prompt beside enc_len_for(seq_len 1,024) =
# 128 frame embeddings; llava: 448 text tokens after its 2,880 patch
# embeddings (t = 3,328, a multiple of the flash kernel's 128 rows) with a
# cache 4,096 deep, at 4 of its 60 layers (12.6 GB of fp32 weights: the
# mesh serve step's peak, 3.7x its weights at gemma2-2b, would near the
# card's 80 GB at 8)
SEAMLESS_TEXT, SEAMLESS_SEQ = 512, 1024
LLAVA_TEXT, LLAVA_SEQ, LLAVA_DEPTH = 448, 4096, 4
# the fp32 prefill/decode check: (text tokens prefilled whole, split); the
# full and the split prefills both t % 128 == 0 with llava's 2,880
ENCDEC_CONSIST = {SEAMLESS: (640, 512), LLAVA: (576, 448)}
# one QuAFL round of seamless at b=8 through build_train_step: 27 leaves,
# d = 977,758,208; one uplink message and the downlink broadcast, each leaf
# padded on its own (d_pad·8 + 32 bits a leaf)
SEAMLESS_D, SEAMLESS_LEAVES, SEAMLESS_BITS = 977_758_208, 27, 7_822_263_136
ENCDEC_TRAIN = {"batch": 8, "seq": 128, "local_steps": 2, "lr": 0.02}


def frontend_serve(smi, dev, mesh, arch) -> dict:
    """seamless-m4t-medium whole (phase ``encdec_serve``) or llava-next-34b
    cut to LLAVA_DEPTH layers (``frontend_serve``) through
    ``build_prefill_step`` and ENCDEC_STEPS greedy ``build_serve_step``
    calls on ``mesh`` (counts from 0 just before the prefill, read just
    after): one flash launch a decoder layer in the prefill (the encoder
    and the cross-attention run plain sdpa, as the reference's), the
    prefill's cache as the serve step's specs describe it, decoding from
    the position after the prefill (the frontend's positions included),
    a greedy rerun identical in tokens and logits, then the fp32
    prefill/decode check."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.specs import enc_len_for
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, rank_blocks)
    from repro_torch.models.model import init_lm
    cfg, reduced = get_config(arch), []
    text, seq = SEAMLESS_TEXT, SEAMLESS_SEQ
    if arch == LLAVA:
        reduced = [f"depth: {LLAVA_DEPTH} of {cfg.n_layers} layers"]
        cfg = cfg.replace(n_layers=LLAVA_DEPTH)
        text, seq = LLAVA_TEXT, LLAVA_SEQ
    pre_shape = ShapeConfig(arch, seq, ENCDEC_BATCH, "prefill")
    dec_shape = ShapeConfig(arch, seq, ENCDEC_BATCH, "decode")
    f = enc_len_for(pre_shape) if cfg.encdec else cfg.n_frontend_tokens
    start = text if cfg.encdec else f + text
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = init_lm(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(v.numel()) for v in params.values())
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    toks = torch.randint(1, cfg.vocab_size, (ENCDEC_BATCH, text),
                         generator=g, device=dev)
    fe = torch.randn((ENCDEC_BATCH, f, cfg.d_model), generator=g,
                     device=dev).to(BF16)
    prefill, _, (p_specs, b_specs) = build_prefill_step(cfg, mesh,
                                                        pre_shape)
    step, _, cache_spec, _ = build_serve_step(cfg, mesh, dec_shape)
    # on the mesh of one every block is its whole leaf
    blocks = rank_blocks(params, p_specs, mesh)
    assert all(blocks[k].shape == v.shape for k, v in params.items())
    del params
    batch = rank_blocks({"tokens": toks, "frontend": fe}, b_specs, mesh)
    n_flash = flash_layers(cfg)
    torch.cuda.empty_cache()

    def serve():
        """(prefill logits, tokens (b, 1 + steps), prefill ms, step ms,
        the prefill's cache)."""
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = prefill(blocks, batch)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t1) * 1e3
        first = cache
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out, ms = [tok], []
        for i in range(ENCDEC_STEPS):
            t1 = time.perf_counter()
            tok, cache = step(blocks, cache, tok, start + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            out.append(tok)
        return logits, torch.cat(out, 1), pre_ms, ms, first

    torch.cuda.reset_peak_memory_stats()
    # the path: counts from 0 just before, read just after
    fa.reset_launches()
    logits, tokens, pre_ms, step_ms, cache = serve()
    launches = fa.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    assert launches == n_flash == cfg.n_layers, (arch, launches)
    assert cache.keys() == cache_spec.keys()
    for k, v in cache.items():   # cross K/V at F = enc_len_for(shape)
        assert v.shape == cache_spec[k].shape, (k, v.shape)
    if cfg.encdec:
        assert cache["body/0/cross/k"].shape[2] == f
    del cache
    assert bool(torch.isfinite(logits).all()), arch
    assert tokens.shape == (ENCDEC_BATCH, ENCDEC_STEPS + 1)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
    logits2, tokens2, pre_ms2, step_ms2, cache = serve()
    del cache
    same_tokens = torch.equal(tokens, tokens2)
    logit_diff = float((logits - logits2).abs().max())
    assert same_tokens and logit_diff == 0.0, (arch, same_tokens,
                                               logit_diff)
    torch.cuda.empty_cache()
    t_full, t_pre = ENCDEC_CONSIST[arch]
    err, scale, n = prefill_decode_consistency(
        cfg, blocks, dev, "float32", t=t_full, t_pre=t_pre,
        frontend=fe[:2])
    assert n == 2 * n_flash, (arch, n)
    assert err <= CONSIST_TOL * scale, (arch, err, scale)
    res = {"phase": "encdec_serve" if cfg.encdec else "frontend_serve",
           "arch": arch, "reduced": reduced, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "params": n_params,
           "init_seconds": init_s, "mesh": dict(mesh.shape),
           "backend": "nccl", "batch": ENCDEC_BATCH, "text_tokens": text,
           "frontend_len": f, "cache_seq": seq, "first_decode_pos": start,
           "flash_layers": n_flash, "flash_launches_prefill": launches,
           "serve_steps": ENCDEC_STEPS, "prefill_ms": [pre_ms, pre_ms2],
           "serve_step_ms_mean": [sum(step_ms) / len(step_ms),
                                  sum(step_ms2) / len(step_ms2)],
           "serve_step_ms_min": min(step_ms + step_ms2),
           "peak_memory_bytes": peak,
           "peak_weight_copies": peak / (4 * n_params),
           "same_tokens": same_tokens,
           "max_abs_logit_diff_vs_run_1": logit_diff,
           "consistency_fp32": {"text": t_full, "split": t_pre,
                                "max_abs_diff": err, "max_abs_logit": scale,
                                "rel": err / scale, "flash_launches": n},
           "tokens": tokens.tolist(), "nvidia_smi": smi}
    emit(res)
    del blocks
    torch.cuda.empty_cache()
    return res


def encdec_train(smi, kx, mesh) -> dict:
    """One QuAFL round of seamless-m4t-medium at full width through
    ``build_train_step`` (``dequant_psum``, b=8) with frontend batches
    (n_slots, K, b, F, d) on ``mesh`` (counts from 0 just before, read just
    after): every leaf's message bits the codec's, exactly d_pad·8 + 32,
    2 encodes and 2 decodes a leaf; a profiled round; then a round of each
    family with every launch recorded on its first TRAIN_PREFIX
    coordinates and held against its plain version: the whole-leaf round,
    and one ``shard_local`` round on the same state."""
    from repro_torch.compression import pipeline
    from repro_torch.compression.rotation import pad_len
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedConfig, ShapeConfig
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.steps import (build_train_step,
                                          init_train_state,
                                          shard_train_state)
    from repro_torch.models.model import lm_loss
    cfg, dev = get_config(SEAMLESS), torch.device("cuda", 0)
    tr = ENCDEC_TRAIN
    fed = FedConfig(bits=8, local_steps=tr["local_steps"], lr=tr["lr"],
                    transport="dequant_psum", kernel_backend="cuda")
    shape = ShapeConfig("encdec_train", tr["seq"], tr["batch"], "train")
    step, spec, (specs, _) = build_train_step(cfg, fed, mesh, shape,
                                              device=dev, seed=SEED)
    assert step.n_slots == 1 and step.fed_mode == "client_dp"
    numel = {k: int(v.numel()) for k, v in spec.server.items()}
    assert sum(numel.values()) == SEAMLESS_D
    assert len(numel) == SEAMLESS_LEAVES
    leaf_bits = {}
    for k, n in numel.items():
        up, dn = (step.quant_up.message_bits(n),
                  step.quant_down.message_bits(n))
        assert up == dn == lattice_bits(pad_len(n)), (k, up, dn)
        leaf_bits[k] = up
    assert sum(leaf_bits.values()) == SEAMLESS_BITS
    full = init_train_state(cfg, SEED, step.n_slots, device=dev)
    state = shard_train_state(full.server, full.clients, full.t, mesh,
                              specs)
    del full
    torch.cuda.empty_cache()
    ins = input_specs(cfg, shape, n_slots=1, local_steps=tr["local_steps"])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     tuple(ins["tokens"].shape), generator=g,
                                     device=dev),
             "frontend": torch.randn(tuple(ins["frontend"].shape),
                                     generator=g, device=dev).to(BF16)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path: counts from 0 just before, read just after
    kx.reset_launches()
    t0 = time.perf_counter()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = dict(kx.LAUNCHES)
    peak_round = torch.cuda.max_memory_allocated()
    assert launches == {k: v * SEAMLESS_LEAVES
                        for k, v in SPMD_LAUNCHES.items()}, launches
    assert math.isfinite(float(m["quant_err_sq"])), m
    (state, m2), wall, kernels = profiled(lambda: step(state, batch, gen))
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_round = port_launches(kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]

    cuda_ops, log = pipeline._REGISTRY["cuda"], []
    pipeline._REGISTRY["cuda"] = recording_ops(cuda_ops, log)
    try:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        checks = check_train_prefixes(kx, log)
        log.clear()
        sl, _, _ = build_train_step(
            cfg, dataclasses.replace(fed, transport="shard_local"), mesh,
            shape, device=dev, seed=SEED)
        kx.reset_launches()
        state, m_sl = sl(state, batch, gen)
        torch.cuda.synchronize()
        sl_launches = dict(kx.LAUNCHES)
        sl_checks = check_train_prefixes(kx, log)
    finally:
        pipeline._REGISTRY["cuda"] = cuda_ops
    del log
    ops_of = {"fused_encode": "encode", "fused_rotate": "rotate",
              "snap_codes": "snap", "fused_decode": "decode"}
    for rows, per_leaf in ((checks, SPMD_LAUNCHES),
                           (sl_checks, SHARD_LOCAL_LAUNCHES)):
        got = check_summary(rows)
        assert {op: got[op]["calls"] for op in got} == {
            ops_of[k]: n * SEAMLESS_LEAVES for k, n in per_leaf.items()
            if n}, got
    assert sl_launches == {k: v * SEAMLESS_LEAVES for k, v in
                           SHARD_LOCAL_LAUNCHES.items()}, sl_launches
    server = step.server_leaves(state)
    with torch.no_grad():
        loss = float(lm_loss(cfg, server, {
            "tokens": batch["tokens"][0, 0],
            "frontend": batch["frontend"][0, 0]})[0])
    del server
    assert math.isfinite(loss) and math.isfinite(float(m_sl["quant_err_sq"]))
    res = {"phase": "encdec_train", "arch": SEAMLESS,
           "mesh": dict(mesh.shape), "backend": "nccl",
           "transport": fed.transport, "d": SEAMLESS_D,
           "leaves": SEAMLESS_LEAVES, "batch": tr["batch"],
           "text_tokens": int(ins["tokens"].shape[-1]),
           "frontend_len": int(ins["frontend"].shape[-2]),
           "local_steps": tr["local_steps"],
           "bits_up_a_round": SEAMLESS_BITS,
           "bits_down_a_round": SEAMLESS_BITS,
           "h_steps_mean": float(m["h_steps_mean"]),
           "quant_err_sq": [float(m["quant_err_sq"]),
                            float(m2["quant_err_sq"])],
           "launches": launches, "launches_a_round_profiled": per_round,
           "first_round_s": round_s, "profiled_round_wall_ms": wall * 1e3,
           "device_ms_a_round": device_ms,
           "device_launches_a_round": sum(e.count for e in kernels),
           "device_busy_share": device_ms / (wall * 1e3),
           "peak_bytes_round": peak_round,
           "peak_model_copies": peak_round / (4 * SEAMLESS_D),
           "top_kernels": [(e.key[:70], e.count,
                            e.self_device_time_total / 1e3) for e in top],
           "server_loss_after": loss,
           "shard_local": {"launches": sl_launches,
                           "quant_err_sq": float(m_sl["quant_err_sq"])},
           "prefix_checks": {"dequant_psum": check_summary(checks),
                             "shard_local": check_summary(sl_checks)},
           "nvidia_smi": smi}
    emit(res)
    return res


def encdec_phases() -> int:
    """``chip_smoke.py --encdec``, in a process of its own: the NCCL group
    of one, then ``encdec_serve``, ``frontend_serve`` and ``encdec_train``
    (each path's counts from 0 just before, read just after)."""
    import torch.distributed as dist
    from repro_torch.kernels import exchange as kx
    from repro_torch.launch.mesh import make_mesh
    smi = smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    nccl_group_of_one()
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        frontend_serve(smi, dev, mesh, SEAMLESS)
        frontend_serve(smi, dev, mesh, LLAVA)
        encdec_train(smi, kx, mesh)
    finally:
        dist.destroy_process_group()
    emit({"phase": "encdec_process", "seconds": time.perf_counter() - t0})
    return 0


def run_encdec() -> None:
    """``chip_smoke.py --encdec`` in a process of its own, its lines
    relayed."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--encdec"], capture_output=True, text=True,
                          timeout=ENCDEC_TIMEOUT)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the encdec phases exited {proc.returncode}")


# ---------------------------------------------------------------------------
# path 14: the dry-run tools (launch/{roofline,hlocost,dryrun,profile_pair},
# the abstract mesh), the shard_map MoE and analysis/opbudget, in a process
# of its own over an NCCL group of one
# ---------------------------------------------------------------------------

TOOLS_BUDGET = 120                # seconds the tools process may take
# the hard limit, past the budget, so that a slow process still reports
# its phases and its seconds before the budget's gate fails it
TOOLS_TIMEOUT = 2 * TOOLS_BUDGET
DRYRUN_RECORDS = 40               # ten archs × four shapes
SHARE_MAX = 1.05                  # bound / device ms above this: a miscount
WALK_BYTES_TOL = 0.01             # abstract vs card bytes, relative
PEAK_FLOPS, HBM_BW = 989e12, 3.35e12   # launch/roofline.py's H100 SXM
SCOUT, SCOUT_LAYERS = "llama4-scout-17b-a16e", 4
SCOUT_B, SCOUT_T, SCOUT_NEW = 4, 512, 16
MOE_TOL = (2e-4, 2e-3)            # tests/test_perf_variants.py:35-36
TOOLS_TRANSPORTS = ("dequant_psum", "code_allgather", "shard_local",
                    "shard_local_codes", "shard_local_rs")


def client_sum_strategy(transport: str):
    """The client-sum strategy whose ``wire_budget`` caps ``transport``'s
    collectives over the client axis: the shard-local exchange's
    (``transport_for_mode``), and for ``code_allgather``, which is no
    shard-local transport, the strategy of that name."""
    from repro_torch.compression.transports import (make_transport,
                                                    transport_for_mode)
    return transport_for_mode(transport) or make_transport(transport)


def dryrun_argv(out: str, mesh: str, arch: str, shape: str) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", mesh, "--out", out]


def start_dryruns(outs) -> tuple:
    """(a)'s two dry runs started, each in a process group of its own, on
    every core but one (this process keeps that one for the card): the
    dry run walks its pairs over as many processes as it may use cores.
    Returns ``(processes, cores)``."""
    import os
    cores = os.sched_getaffinity(0)
    host = set(sorted(cores)[1:]) or cores
    os.sched_setaffinity(0, host)      # inherited by the dry runs
    try:
        procs = [subprocess.Popen(argv, cwd=ROOT, env=dryrun_env(),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  start_new_session=True)
                 for argv in (dryrun_argv(outs[0], "single", "all", "all"),
                              dryrun_argv(outs[1], "multi", "llama3.2-1b",
                                          "train_4k"))]
    finally:
        os.sched_setaffinity(0, cores)
    return procs, len(host)


def dryrun_env() -> dict:
    """The dry run's environment: the port on the path, no card."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(ROOT / "src") + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def stop_tree(proc) -> None:
    """Stop the dry run and the processes it started (its own process
    group)."""
    import os
    import signal
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def dryrun_phase(procs, cores: int, t0: float, outs) -> dict:
    """(a): the dry run of every pair as a user runs it, and one
    ``--mesh multi`` pair (both started by the caller, on the host while
    the card works); every record [OK] or the reference's [SKIP] note,
    none [FAIL]."""
    import os
    from repro_torch.configs import get_config
    got = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=TOOLS_TIMEOUT)
        assert proc.returncode == 0, stderr[-4000:]
        got.append([ln for ln in stdout.splitlines() if ln.startswith("[")])
    seconds = time.perf_counter() - t0
    lines, lines_multi = got
    assert len(lines) == DRYRUN_RECORDS, lines
    assert len(lines_multi) == 1 and lines_multi[0].startswith("[OK]")
    assert not any(ln.startswith("[FAIL]") for ln in lines), lines
    records = {}
    for out in outs:
        for name in sorted(os.listdir(out)):
            res = json.loads((Path(out) / name).read_text())
            tag = name[:-len(".json")]
            if "skipped" in res:
                cfg = get_config(res["arch"])
                assert res["shape"] == "long_500k" and not cfg.long_500k_ok
                assert res["skipped"] == cfg.long_500k_note, res
                records[tag] = "skipped"
                continue
            r = res["roofline"]
            records[tag] = [res["flops_per_device"],
                            res["bytes_per_device"], r["compute_s"],
                            r["memory_s"], r["collective_s"],
                            r["bottleneck"], res["useful_flops_ratio"],
                            res["memory"]["temp_bytes"], res["lower_s"]]
    n_ok = sum(ln.startswith("[OK]") for ln in lines)
    row = {"phase": "tools_dryrun", "seconds_until_read": seconds,
           "ok": n_ok, "skipped": len(lines) - n_ok, "cores": cores,
           "multi": lines_multi[0],
           "fields": ["flops_per_device", "bytes_per_device", "compute_s",
                      "memory_s", "collective_s", "bottleneck",
                      "useful_flops_ratio", "temp_bytes", "lower_s"],
           "records": records}
    emit(row)
    return row


def grounded_steps():
    """(b)'s four steps that fit one card: (name, cfg, shape)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    return (("gemma2_prefill_4k", get_config(GEMMA),
             ShapeConfig("prefill_4k", 4096, 4, "prefill")),
            ("gemma2_serve_4k", get_config(GEMMA),
             ShapeConfig("decode_4k", 4096, 4, "decode")),
            ("llama_spmd_full", get_config("llama3.2-1b"),
             ShapeConfig("spmd_full", 128, 8, "train")),
            ("scout_prefill_shmap", scout_config("ragged_shmap", "bfloat16"),
             ShapeConfig("scout_prefill", SCOUT_T, SCOUT_B, "prefill")))


def grounded_args(cfg, shape, fed, mesh, dev, transport):
    """The step of (cfg × shape) on ``mesh`` and the card, random weights
    from seed 0: ``(step, call, argument tensors)``."""
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step,
                                          build_train_step,
                                          init_train_state,
                                          shard_train_state)
    from repro_torch.models.model import init_cache, init_lm
    from repro_torch.sharding.rules import cut_block
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    coords = mesh.coords()

    def tokens(like):
        return torch.randint(0, cfg.vocab_size, tuple(like.shape),
                             generator=gen, device=dev, dtype=like.dtype)

    if shape.kind == "train":
        step, _, (specs, _) = build_train_step(
            cfg, fed, mesh, shape, transport=transport, device=dev)
        full = init_train_state(cfg, SEED, step.n_slots, device=dev)
        state = shard_train_state(full.server, full.clients, 0, mesh, specs)
        del full
        batch = {k: tokens(v) for k, v in input_specs(
            cfg, shape, n_slots=step.n_slots,
            local_steps=fed.local_steps).items()}
        return step, (lambda: step(state, batch)), (state, batch)
    params, _ = init_lm(cfg, seed=SEED, device=dev)
    if shape.kind == "prefill":
        step, _, (p_specs, b_specs) = build_prefill_step(cfg, mesh, shape)
        blocks = {k: cut_block(v, p_specs[k], mesh.shape, coords)
                  for k, v in params.items()}
        batch = {k: tokens(v) for k, v in input_specs(cfg, shape).items()}
        return step, (lambda: step(blocks, batch)), (blocks, batch)
    step, _, _, (p_specs, c_specs, t_spec, _) = build_serve_step(cfg, mesh,
                                                                 shape)
    blocks = {k: cut_block(v, p_specs[k], mesh.shape, coords)
              for k, v in params.items()}
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, dev)
    token = tokens(input_specs(cfg, shape)["token"])
    return step, (lambda: step(blocks, cache, token, shape.seq_len - 1)), (
        blocks, cache, token)


def grounded_step(smi, dev, mesh, name, cfg, shape, fed, transport,
                  fa, kx) -> dict:
    """(b): one step counted abstractly (``dryrun.walk_step`` on an
    abstract (1, 1) mesh) and on its real run on the card under the same
    walker: flops equal, bytes within 1%; then profiled after a warm-up,
    its bound over its device ms, the measured peak beside the count's,
    and ``profile_pair``'s top records beside the profiler's top kernels."""
    from repro_torch.kernels import grouped_mm as gm
    from repro_torch.launch.dryrun import walk_step
    from repro_torch.launch.hlocost import CostWalker, top_contributors
    from repro_torch.launch.mesh import make_abstract_mesh
    abstract = make_abstract_mesh((1, 1), ("data", "model"))
    w_abs, arg_b, _, lower_s, _, _ = walk_step(
        cfg, shape, abstract, fed, transport=transport, records=True)
    s_abs = w_abs.summary()
    temp_b = s_abs["peak_live_bytes"] - arg_b
    _, call, args = grounded_args(cfg, shape, fed, mesh, dev, transport)
    call()                                       # warm-up (caches, builds)
    torch.cuda.synchronize()
    fa.reset_launches()
    kx.reset_launches()
    gm.reset_launches()
    w = CostWalker(mesh)
    w.track(args)
    with mesh.recording(), w:
        out = call()
    torch.cuda.synchronize()
    del out
    launched = {k: v for k, v in {**fa.LAUNCHES, **kx.LAUNCHES,
                                  **gm.LAUNCHES}.items() if v}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    _, wall, kernels = profiled(call)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    bound_ms = max(s_abs["flops"] / PEAK_FLOPS,
                   s_abs["bytes"] / HBM_BW) * 1e3
    share = bound_ms / device_ms
    top_k = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    res = {"phase": "tools_grounded", "step": name, "arch": cfg.name,
           "n_layers": cfg.n_layers, "shape": [shape.name, shape.seq_len,
                                               shape.global_batch,
                                               shape.kind],
           "transport": transport if shape.kind == "train" else "-",
           "abstract": {"flops": s_abs["flops"], "bytes": s_abs["bytes"],
                        "kernel_flops": s_abs["kernel_flops"],
                        "kernels": s_abs["kernels"], "lower_s": lower_s},
           "card": {"flops": w.flops, "bytes": w.bytes,
                    "kernel_flops": w.kernel_flops,
                    "kernels": dict(w.kernels), "launches": launched},
           "bytes_rel_diff": abs(w.bytes - s_abs["bytes"]) / s_abs["bytes"],
           "bound_ms": bound_ms,
           "bound_by": ("operations" if s_abs["flops"] / PEAK_FLOPS
                        >= s_abs["bytes"] / HBM_BW else "bytes"),
           "device_ms": device_ms, "wall_ms": wall * 1e3, "share": share,
           "peak_measured_bytes": peak, "allocated_before_bytes": before,
           "argument_bytes": arg_b, "temp_bytes": temp_b,
           "peak_counted_bytes": arg_b + temp_b,
           "top_records": [[r["op"], r["bytes"], r["flops"], r["count"],
                            r["where"]] for r in top_contributors(w_abs, 10)],
           "top_kernels": [[e.key[:80], e.count,
                            e.self_device_time_total / 1e3] for e in top_k],
           "nvidia_smi": smi}
    emit(res)
    assert w.flops == s_abs["flops"], (w.flops, s_abs["flops"])
    assert res["bytes_rel_diff"] <= WALK_BYTES_TOL, res["bytes_rel_diff"]
    assert dict(w.kernels) == s_abs["kernels"], res
    if dev.type == "cuda":      # the plain versions launch nothing
        assert launched == s_abs["kernels"], res
    assert share <= SHARE_MAX, share
    del args, call
    torch.cuda.empty_cache()
    return res


def scout_config(impl: str, dtype: str):
    import dataclasses as dc
    from repro_torch.configs import get_config
    cfg = get_config(SCOUT).replace(n_layers=SCOUT_LAYERS, dtype=dtype)
    return cfg.replace(moe=dc.replace(cfg.moe, impl=impl))


def scout_serve(params, prompts, mesh, impl: str, dtype: str, fa) -> dict:
    """The mesh prefill and SCOUT_NEW greedy serve steps of llama4-scout at
    SCOUT_LAYERS layers: the prefill's last logits, the tokens and the
    prefill's flash launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    cfg = scout_config(impl, dtype)
    seq = SCOUT_T + SCOUT_NEW
    prefill = build_prefill_step(cfg, mesh, ShapeConfig(
        "scout_prefill", seq, SCOUT_B, "prefill"))[0]
    serve = build_serve_step(cfg, mesh, ShapeConfig(
        "scout_decode", seq, SCOUT_B, "decode"))[0]
    fa.reset_launches()
    with torch.no_grad():
        last, cache = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        flash = fa.LAUNCHES["flash_attention"]
        tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(SCOUT_NEW):
            tok, cache = serve(params, cache, tok, SCOUT_T + i)
            toks.append(tok)
    torch.cuda.synchronize()
    return {"last": last.float().cpu(), "tokens": torch.cat(toks, 1).cpu(),
            "flash": flash}


def scout_phase(smi, dev, mesh, fa) -> dict:
    """(c): llama4-scout at 4 of 48 layers through the mesh prefill and 16
    greedy serve steps with 'ragged_shmap' over the NCCL group of one and
    with 'ragged' (on the local (1, 1) mesh, where the steps gather
    nothing, so the 35 GB of expert weights are not copied a second time):
    tokens identical, fp32 logits within the reference's tolerance, the
    bf16 agreement printed, one flash launch a prefill."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import init_lm
    t0 = time.perf_counter()
    params, _ = init_lm(scout_config("ragged", "float32"), seed=SEED,
                        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    prompts = torch.randint(0, params["embed/tok"].shape[0],
                            (SCOUT_B, SCOUT_T), generator=gen, device=dev,
                            dtype=torch.int32)
    local = Mesh((1, 1), ("data", "model"))
    runs = {(impl, dt): scout_serve(params, prompts, m, impl, dt, fa)
            for dt in ("float32", "bfloat16")
            for impl, m in (("ragged_shmap", mesh), ("ragged", local))}
    res = {"phase": "tools_scout_serve", "arch": SCOUT,
           "layers": SCOUT_LAYERS, "reduced": f"n_layers {SCOUT_LAYERS} of 48",
           "batch": SCOUT_B, "prompt": SCOUT_T, "new_tokens": SCOUT_NEW,
           "seconds": 0.0, "nvidia_smi": smi}
    for dt in ("float32", "bfloat16"):
        a, b = runs[("ragged_shmap", dt)], runs[("ragged", dt)]
        err = (a["last"] - b["last"]).abs()
        res[dt] = {"tokens_equal": bool(torch.equal(a["tokens"],
                                                    b["tokens"])),
                   "max_abs_logit_diff": float(err.max()),
                   "max_abs_logit": float(b["last"].abs().max()),
                   "flash_per_prefill": [a["flash"], b["flash"]]}
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    flash = flash_layers(scout_config("ragged", "float32")) \
        if dev.type == "cuda" else 0
    for dt in ("float32", "bfloat16"):
        assert res[dt]["tokens_equal"], res
        assert res[dt]["flash_per_prefill"] == [flash, flash], res
    a, b = runs[("ragged_shmap", "float32")], runs[("ragged", "float32")]
    atol, rtol = MOE_TOL
    assert torch.allclose(a["last"], b["last"], atol=atol, rtol=rtol), res
    del params, runs
    torch.cuda.empty_cache()
    return res


def opbudget_phase(smi, dev, mesh, kx) -> dict:
    """(d): the rotation budget of QuAFL at the paper's cell on the card
    (rows 1-4 launched), and the collective bytes over the client axis of
    one reduced mesh round of each transport against its client-sum
    strategy's ``wire_budget`` caps (summed over the leaves); a cap one
    byte under what was measured gives exactly one violation."""
    from repro_torch.analysis.opbudget import (check_collective_bytes,
                                               check_rotation_budget,
                                               collective_bytes,
                                               measure_round_counters,
                                               rotation_budget)
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedConfig, ShapeConfig
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.models.mlp import mlp_loss_batched
    t0 = time.perf_counter()
    fed, part, _, p0, gen = chip_world(dev)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched,
                         template=p0, batch_size=32, device=dev)
    state = alg.init(p0)
    kx.reset_launches()
    counters = measure_round_counters(alg, state, part, gen).counters
    rot = check_rotation_budget(alg, state, part, gen, "quafl@n300s16")
    torch.cuda.synchronize()
    rot_launches = dict(kx.LAUNCHES)
    res = {"phase": "tools_opbudget", "rotation_counters": counters,
           "rotation_budget": rotation_budget(S),
           "rotation_violations": [v.as_dict() for v in rot],
           "rotation_launches": rot_launches, "transports": {},
           "nvidia_smi": smi}
    cfg = get_reduced("llama3.2-1b")
    shape = ShapeConfig("tools_reduced", 64, 4, "train")
    rfed = FedConfig(n_clients=1, s=1, local_steps=2, lr=0.05, bits=8,
                     kernel_backend="cuda")
    for tr in TOOLS_TRANSPORTS:
        step, call, (state_r, _) = grounded_args(cfg, shape, rfed, mesh,
                                                 dev, tr)
        with mesh.recording() as records:
            call()
        torch.cuda.synchronize()
        client = [r for r in records if r["axis"] == step.client_axis]
        budget = client_sum_strategy(tr)
        caps = {}
        for v in state_r.server.values():
            for key, cap in budget.wire_budget(step.quant_up,
                                               step.quant_down, v.numel(),
                                               step.n_slots).caps.items():
                caps[key] = caps.get(key, 0) + cap
        got = collective_bytes(client)
        viol = check_collective_bytes(client, tr, caps)
        key = max(got, key=got.get)
        short = check_collective_bytes(client, tr,
                                       dict(caps, **{key: got[key] - 1}))
        res["transports"][tr] = {
            "strategy": budget.name, "bytes": got,
            "caps": {k: caps[k] for k in got},
            "violations": [v.as_dict() for v in viol],
            "one_byte_short": {"key": key,
                               "violations": [v.as_dict() for v in short]},
            "records": len(records)}
        assert viol == [], res["transports"][tr]
        assert len(short) == 1 and key in short[0].detail, short
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    assert rot == [] and counters == rotation_budget(S), res
    for k in ("fused_encode", "fused_rotate", "uplink", "average",
              "quantize_codes"):
        assert rot_launches[k] > 0 or dev.type != "cuda", (k, rot_launches)
    return res


def tools_phases() -> int:
    """``chip_smoke.py --tools``, in a process of its own: the dry run
    started on the host, then over the NCCL group of one the grounded
    steps, the scout serving and the op budgets (each path's counts from 0
    just before, read just after), then the dry run's records."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.base import FedConfig
    from repro_torch.kernels import exchange as kx
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    smi = smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    outs = [tempfile.mkdtemp(prefix="dryrun_") for _ in range(2)]
    procs, cores = start_dryruns(outs)
    nccl_group_of_one()
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        # spmd_full's round (SPMD_ARGV): b=8, t=128, K=2, lr 0.02, 8 bits
        fed = FedConfig(n_clients=1, s=1, local_steps=2, lr=0.02, bits=8,
                        kernel_backend="cuda")
        for name, cfg, shape in grounded_steps():
            grounded_step(smi, dev, mesh, name, cfg, shape, fed,
                          "dequant_psum", fa, kx)
        scout_phase(smi, dev, mesh, fa)
        opbudget_phase(smi, dev, mesh, kx)
    except BaseException:
        for proc in procs:
            stop_tree(proc)
        raise
    finally:
        dist.destroy_process_group()
    try:
        dryrun_phase(procs, cores, t0, outs)
    except BaseException:
        for proc in procs:
            stop_tree(proc)
        raise
    finally:
        for out in outs:
            shutil.rmtree(out, ignore_errors=True)
    emit({"phase": "tools_process", "seconds": time.perf_counter() - t0})
    return 0


def run_tools() -> None:
    """``chip_smoke.py --tools`` in a process of its own, its lines
    relayed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--tools"], capture_output=True, text=True,
                          timeout=TOOLS_TIMEOUT)
    seconds = time.perf_counter() - t0
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the tools phases exited {proc.returncode}")
    emit({"phase": "tools_wall", "seconds": seconds,
          "budget": TOOLS_BUDGET})
    assert seconds <= TOOLS_BUDGET, (seconds, TOOLS_BUDGET)


# ---------------------------------------------------------------------------
# path 15: the invariant gate (analysis/) on the card, its own process
# ---------------------------------------------------------------------------

ANALYSIS_BUDGET = 120             # seconds the analysis process may take
ANALYSIS_TIMEOUT = 2 * ANALYSIS_BUDGET
ANALYSIS_CHUNK = ENGINE_CHUNK     # rounds of the chunk whose graph is read
# the rows the gate's cells launch (the lattice exchange, and the
# per-message decodes of the baselines)
ANALYSIS_KERNELS = ("fused_encode", "fused_rotate", "quantize_codes",
                    "snap_codes", "fused_decode", "uplink", "average")


def lint_phase(smi, mesh, kx) -> dict:
    """(a) ``run_lint`` over the whole matrix on the card: every cell's
    round and chunk op logs, wire truth and intervals, the in-place audit
    of captured chunks, the sentinels' ``simulate(scan_chunk=2)`` runs,
    every captured round under ``torch.cuda.set_sync_debug_mode("error")``
    (``fed/engine.sync_debug``), and each exchange cell also on real
    tensors over the NCCL group of one with its replicated outputs held
    equal across ranks. 0 violations; rows 1-5 launched."""
    from repro_torch.analysis.lint import run_lint
    from repro_torch.fed.engine import sync_debug
    t0 = time.perf_counter()
    timings = {}
    kx.reset_launches()
    with sync_debug("error"):
        rep = run_lint(device="cuda", mesh=mesh, verbose=False,
                       timings=timings)
    torch.cuda.synchronize()
    launches = {k: kx.LAUNCHES[k] for k in ANALYSIS_KERNELS}
    cells = [c for sec in ("matrix", "exchange", "sentinel")
             for c in rep[sec].values()] + [rep["rs_transport"]]
    viols = rep["ast"]["violations"] + [v for c in cells
                                        for v in c["violations"]]
    res = {"phase": "analysis_lint", "device": rep["device"],
           "sync_debug": "error",
           "violations_total": rep["violations_total"],
           "violations": viols[:20],
           "cells": {sec: len(rep[sec]) for sec in ("matrix", "exchange",
                                                   "sentinel")},
           "programs": {a: r.get("programs")
                        for a, r in rep["sentinel"].items()},
           "donation": {c: r.get("donation")
                        for c, r in rep["matrix"].items()},
           "divergence_ranks": {c: r.get("ranks")
                                for c, r in rep["exchange"].items()},
           "launches": launches,
           "slowest": sorted(timings.items(), key=lambda kv: -kv[1])[:6],
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(res)
    assert rep["violations_total"] == 0, viols
    assert res["cells"] == {"matrix": 25, "exchange": 9, "sentinel": 8}, res
    assert all(res["divergence_ranks"].values()), res
    for a, prog in res["programs"].items():
        assert prog and set(prog.values()) == {1}, (a, prog)
    for c, don in res["donation"].items():
        assert don["steady_chunks"] > 0 and don["leaves_copied"] == 0 \
            and don.get("leaves_not_static") == 0, (c, don)
    for k in ANALYSIS_KERNELS:
        assert launches[k] > 0, (k, launches)
    return res


def lowered_phase(smi, dev, kx) -> dict:
    """(b) the kernel nodes of a 10-round QuAFL chunk at the paper's cell
    (``RoundEngine.lowered_chunk``: the captured graph's debug dump) equal,
    kernel by kernel, the port launches the profiler's device events count
    in a replay of the same chunk, and a round's are the main path's
    (``TRAIN_LAUNCHES``: 1 encode, 3 rotations, 1 quantize, the uplink
    and the averaging snap);
    neither the caller's generator nor the engine's cache moves."""
    from repro_torch.fed.engine import RoundEngine, clone_tree
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.models.mlp import mlp_loss_batched
    t0 = time.perf_counter()
    fed, part, _, p0, gen = chip_world(dev)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched, template=p0,
                         batch_size=32, device=dev)
    state = alg.init(p0)
    eng = RoundEngine(alg)
    g0 = gen.get_state()
    nodes = eng.lowered_chunk(state, part, gen, ANALYSIS_CHUNK)
    untouched = (bool(torch.equal(gen.get_state(), g0))
                 and eng.chunk_programs() == {})
    in_graph = {k: sum(bool(re.search(sym, label)) for label in nodes)
                for k, sym in KERNEL_SYMBOLS.items()}
    st, _ = eng.run_chunk(clone_tree(state), part, gen, ANALYSIS_CHUNK)
    for _ in range(3):   # the trace now and then drops events: again
        (st, _), _, ev = profiled(lambda: eng.run_chunk(st, part, gen,
                                                        ANALYSIS_CHUNK))
        replayed = port_launches(ev)
        if replayed == in_graph:
            break
    res = {"phase": "analysis_lowered_chunk", "rounds": ANALYSIS_CHUNK,
           "graph_kernel_nodes": len(nodes), "in_graph": in_graph,
           "replayed": replayed, "caller_untouched": untouched,
           "first_kernel_node": nodes[0][:240] if nodes else None,
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(res)
    assert untouched and nodes, res
    assert in_graph == replayed == {k: ANALYSIS_CHUNK * v
                                    for k, v in TRAIN_LAUNCHES.items()}, res
    return res


def analysis_phases() -> int:
    """``chip_smoke.py --analysis``, in a process of its own over the NCCL
    group of one: the gate's whole matrix, then the captured chunk's kernel
    list against its replay (each path's counts from 0 just before, read
    just after)."""
    import torch.distributed as dist
    from repro_torch.kernels import exchange as kx
    from repro_torch.launch.mesh import make_mesh
    smi = smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    nccl_group_of_one()
    try:
        lint_phase(smi, make_mesh((1, 1), ("data", "model")), kx)
        lowered_phase(smi, dev, kx)
    finally:
        dist.destroy_process_group()
    emit({"phase": "analysis_process", "seconds": time.perf_counter() - t0})
    return 0


def run_analysis() -> None:
    """``chip_smoke.py --analysis`` in a process of its own, its lines
    relayed; its wall gated at ``ANALYSIS_BUDGET``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--analysis"], capture_output=True, text=True,
                          timeout=ANALYSIS_TIMEOUT)
    seconds = time.perf_counter() - t0
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the analysis phases exited {proc.returncode}")
    emit({"phase": "analysis_wall", "seconds": seconds,
          "budget": ANALYSIS_BUDGET})
    assert seconds <= ANALYSIS_BUDGET, (seconds, ANALYSIS_BUDGET)


# ---------------------------------------------------------------------------
# path 16: the MoE's grouped product on device offsets, its own process
# ---------------------------------------------------------------------------

MOE_BUDGET = 120                  # seconds the moe process may take
MOE_TIMEOUT = 2 * MOE_BUDGET
DEEPSEEK = "deepseek-v2-236b"
GROUPED_KERNELS = ("grouped_mm_fwd", "grouped_mm_dgrad", "grouped_mm_wgrad")
# each wrapper's kernels, by a substring of their symbols: bf16 launches a
# wgmma kernel (forward and dgrad also the ordered sum of their slices
# where K is split), fp32 the CUDA-core kernel
GROUPED_SYMBOLS = {"grouped_mm_fwd": ("grouped_fwd_wgmma_kernel",
                                      "grouped_fwd_sum_kernel",
                                      "grouped_fwd_kernel"),
                   "grouped_mm_dgrad": ("grouped_dgrad_wgmma_kernel",
                                        "grouped_dgrad_sum_kernel",
                                        "grouped_dgrad_kernel"),
                   "grouped_mm_wgrad": ("grouped_wgrad_wgmma_kernel",
                                        "grouped_wgrad_kernel")}
# jax.lax.ragged_dot in the reference's _moe_ragged (no Pallas kernel)
GROUPED_REPLACES = "src/repro/models/moe.py:72"
# routed tokens: batch A's 4 x 512 prefill and a decode step of 4
GROUPED_TOKENS = ((DEEPSEEK, 2048), (DEEPSEEK, 4), (SCOUT, 2048), (SCOUT, 4))
# every expert product's shape: gate and up (K d_model, N d_ff_expert; up
# is gate's shape) and down (K d_ff_expert, N d_model)
GROUPED_WEIGHTS = ("w_gate", "w_down")
GROUPED_MAIN = (DEEPSEEK, 2048, "bfloat16", "w_gate")  # the kernels line's
GROUPED_ITERS = 5
# fp32: max|Δ| / max|want|; bf16 (the compute dtype or the output's, as
# dW of a bf16 product stored in fp32): ‖Δ‖ / ‖want‖. w rounded to bf16 by
# truncation rather than to nearest-even is ~4.7e-3 off at these widths.
GROUPED_TOL = {FP32: 1e-5, BF16: 1e-3}
MOE_CHUNK_ARGV = ["--reduced", "--batch", "4", "--seq", "64", "--log-every",
                  "1", "--lr", "0.05", "--steps", "4", "--seed", "0"]
MOE_CHUNK_ARCHS = (DEEPSEEK, SCOUT, "jamba-1.5-large-398b")
MOE_LAYER_TOKENS = (4, 512)
EDGE_NAN_ROWS = 123   # rows of no group, NaN, in the edge case nan_outside


def grouped_err(got, want, dtype):
    """(the gate's measure, its tolerance): fp32 where the compute dtype
    and the output's are fp32, else bf16 (GROUPED_TOL)."""
    d = (got.float() - want.float())
    if BF16 not in (dtype, got.dtype):
        return (float(d.abs().max()) / max(float(want.abs().max()), 1e-30),
                GROUPED_TOL[FP32])
    return (float(d.norm()) / max(float(want.float().norm()), 1e-30),
            GROUPED_TOL[BF16])


def grouped_case(gm, x, w, dy, offs) -> dict:
    """fwd, dgrad and wgrad against their plain versions: the gate's
    measure, its tolerance and the max abs error of each."""
    out = {}
    for k, got, want in (
            ("grouped_mm_fwd", gm.grouped_mm_fwd(x, w, offs),
             gm.grouped_mm_plain(x, w, offs)),
            ("grouped_mm_dgrad", gm.grouped_mm_dgrad(dy, w, offs),
             gm.grouped_mm_dgrad_plain(dy, w, offs)),
            ("grouped_mm_wgrad",
             gm.grouped_mm_wgrad(x, dy, offs, w_dtype=w.dtype),
             gm.grouped_mm_wgrad_plain(x, dy, offs, w_dtype=w.dtype))):
        err, tol = grouped_err(got, want, x.dtype)
        out[k] = {"err": err, "tol": tol, "max_abs_err":
                  float((got.float() - want.float()).abs().max())}
        assert err <= tol, (k, err, tol)
    torch.cuda.synchronize()
    return out


def grouped_library(x, w, dy, offs):
    """The yardsticks of each kernel on the same inputs in bf16 (the port
    never calls them): ``library``, one ``torch._grouped_mm`` call on bf16
    weights; ``library_cast``, the reference's own work, the cast of the
    weights to bf16 (``.astype(x.dtype)``) and then that call (wgrad: the
    call, then its cast back to w's dtype); each None where the call
    refuses the shape. Then the refusals, if any."""
    w_lib = w.to(BF16)
    calls = {"grouped_mm_fwd": (lambda: torch._grouped_mm(x, w_lib, offs),
                                lambda: torch._grouped_mm(x, w.to(BF16),
                                                          offs)),
             "grouped_mm_dgrad": (
                 lambda: torch._grouped_mm(dy, w_lib.transpose(-2, -1),
                                           offs),
                 lambda: torch._grouped_mm(
                     dy, w.to(BF16).transpose(-2, -1), offs)),
             "grouped_mm_wgrad": (
                 lambda: torch._grouped_mm(x.t(), dy, offs),
                 lambda: torch._grouped_mm(x.t(), dy, offs).to(w.dtype))}
    out, why = {"library": {}, "library_cast": {}}, {}
    for k, fns in calls.items():
        for kind, fn in zip(out, fns):
            try:
                out[kind][k] = time_ms(fn, GROUPED_ITERS)
            except (RuntimeError, TypeError, ValueError) as e:
                out[kind][k], why[k] = None, str(e).splitlines()[0][:160]
    del w_lib
    return out, why


def grouped_geometry(gm, x, w, dy, ptxas) -> dict:
    """The bf16 kernels' launches at these shapes, from shapes alone: the
    forward's and dgrad's (``rows_plan``: row tile BR, slices S of the
    reduction, CTAs launched and expected busy, the ring's stages and a
    CTA's shared memory) and wgrad's (``wgrad_plan``: dW tile 128 × BN,
    items, persistent CTAs, stages, shared memory by the plan and by the
    library); and ptxas's registers and spills of each kernel at that BR
    (and of the ordered sum where S > 1), of wgrad at both BN."""
    lib, sms = gm.library(), gm.sm_count(x.device.index)
    wb = int(w.dtype == BF16)
    wt = "bf16" if wb else "f32"
    out = {}
    for name, kind, a, nout in (("grouped_mm_fwd", "fwd", x, w.shape[2]),
                                ("grouped_mm_dgrad", "dgrad", dy,
                                 w.shape[1])):
        plan = gm.rows_plan(a.shape[0], w.shape[0], a.shape[1], nout, sms)
        sym = f"grouped_{kind}_wgmma_kernel<{plan.br},{wt}>"
        out[name] = {**plan._asdict(),
                     "stages": lib.grouped_rows_plan(plan.br, wb, 1),
                     "smem_bytes": lib.grouped_rows_plan(plan.br, wb, 0),
                     "ptxas": {k: v for k, v in ptxas.items()
                               if k == sym or (plan.splits > 1 and k ==
                                               f"grouped_{kind}_sum_kernel")}}
    e, k, n = w.shape
    plan = gm.wgrad_plan(x.shape[0], e, k, n, w.dtype, sms)
    out["grouped_mm_wgrad"] = {
        **plan._asdict(), "tile": [gm.WGRAD_TILE_K, plan.bn],
        "smem_bytes_library": lib.grouped_wgrad_plan(plan.bn, wb,
                                                     plan.stages, e),
        "ptxas": {k: v for k, v in ptxas.items()
                  if k.startswith("grouped_wgrad_wgmma_kernel<")
                  and k.endswith(f",{wt}>")}}
    assert out["grouped_mm_wgrad"]["smem_bytes_library"] == plan.smem_bytes
    return out


def ms_per_call(kernels, symbols: dict, calls: int) -> dict:
    """Device ms a wrapper call of each named wrapper (None if none of its
    kernels ran): the device time of every kernel whose symbol holds one
    of its substrings, over ``calls``."""
    out = {}
    for name, subs in symbols.items():
        hits = [e for e in kernels if any(s in e.key for s in subs)]
        out[name] = (sum(e.self_device_time_total for e in hits) / calls
                     / 1e3 if hits else None)
    return out


def grouped_times(gm, x, w, dy, offs, peak_bw, lib) -> dict:
    """ms (CUDA events over wrapper calls), device ms a call (profiler:
    every kernel the wrapper launches), the plain loop's ms, the
    library's and the cast-plus-library's (``lib``), and the bound over
    this routing: bytes of x, the output and offs, the weights of the
    experts that have rows (fwd, dgrad) or all of dW written (wgrad),
    against 2·R·K·N flops at the peak of the compute dtype."""
    r, (e, k, n) = x.shape[0], w.shape
    active = int((torch.diff(offs, prepend=offs.new_zeros(1)) > 0).sum())
    xs, ws = x.element_size(), w.element_size()
    rate = PEAK_BF16_OPS_PER_S if x.dtype == BF16 else PEAK_FP32_OPS_PER_S
    calls = {"grouped_mm_fwd": (lambda: gm.grouped_mm_fwd(x, w, offs),
                                lambda: gm.grouped_mm_plain(x, w, offs)),
             "grouped_mm_dgrad": (lambda: gm.grouped_mm_dgrad(dy, w, offs),
                                  lambda: gm.grouped_mm_dgrad_plain(
                                      dy, w, offs)),
             "grouped_mm_wgrad": (
                 lambda: gm.grouped_mm_wgrad(x, dy, offs, w_dtype=w.dtype),
                 lambda: gm.grouped_mm_wgrad_plain(x, dy, offs,
                                                   w_dtype=w.dtype))}

    def all_three():
        for kernel, _ in calls.values():
            kernel()

    device = None
    for _ in range(3):      # the trace now and then holds no kernel events
        _, _, ev = profiled(lambda: [all_three()
                                     for _ in range(GROUPED_ITERS)])
        device = ms_per_call(ev, GROUPED_SYMBOLS, GROUPED_ITERS)
        if all(v is not None for v in device.values()):
            break
    out = {}
    for name, (kernel, plain) in calls.items():
        weights = e * k * n * ws if name == "grouped_mm_wgrad" \
            else active * k * n * ws
        b_ms, b_by = bound(r * (k + n) * xs + 4 * e + weights,
                           2.0 * r * k * n, peak_bw, rate)
        out[name] = {"ms": time_ms(kernel, GROUPED_ITERS),
                     "plain_ms": time_ms(plain, GROUPED_ITERS),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib.get("library", {}).get(name),
                     "library_cast_ms": lib.get("library_cast",
                                                {}).get(name),
                     "device_ms": device[name]}
    if x.dtype == BF16:
        # the bf16 wgrad at each dW tile width it is built for, the plan's
        # choice among them
        dw = torch.empty(w.shape, dtype=w.dtype, device=x.device)
        sms = gm.sm_count(x.device.index)
        plans = {bn: gm.wgrad_plan(r, e, k, n, w.dtype, sms, bn=bn)
                 for bn in gm.WGRAD_TILES_N}
        out["grouped_mm_wgrad"]["ms_by_bn"] = {
            bn: time_ms(lambda p=p: gm._launch_wgrad(x, dy, offs, dw, p),
                        GROUPED_ITERS) for bn, p in plans.items()}
        del dw
    out["active_experts"] = active
    return out


def routed_rows(cfg, p, tokens, gen, dev):
    """x (tokens·k, d) in fp32 sorted by expert, and its offsets, routed
    by the arch's router (seed-0 weights) from random hidden states."""
    from repro_torch.models import moe
    m = cfg.moe
    h = torch.randn((tokens, cfg.d_model), generator=gen, device=dev)
    _, idx, _ = moe._router(cfg, p, h, "moe/")
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    return h[order // m.top_k], moe.group_offsets(flat, m.n_experts)


def edge_offsets(e: int, dev) -> dict:
    """Offsets of the edge cases at E experts: every row in one expert,
    empty first and last experts (rows spread over the others), fewer
    rows than one 64-row tile, and ``nan_outside`` (``below_a_tile``'s
    groups, then EDGE_NAN_ROWS rows of no group that hold NaN in x and dy:
    the last groups' row boxes run into them)."""
    rng = np.random.default_rng(SEED)
    spread = np.zeros(e, np.int64)
    spread[1:-1] = rng.multinomial(1000, np.ones(e - 2) / (e - 2))
    one = np.zeros(e, np.int64)
    one[e // 2] = 256
    below = np.bincount([1, 1, e // 2, e - 2, e - 2], minlength=e)
    return {name: torch.tensor(np.cumsum(c), dtype=torch.int32, device=dev)
            for name, c in (("one_expert", one), ("empty_ends", spread),
                            ("below_a_tile", below), ("nan_outside", below))}


def moe_params(cfg, dev):
    """The arch's MoE layer (router, experts, shared experts) at its
    published widths, fp32, from seed 0, under the prefix 'moe'."""
    from repro_torch.models.moe import init_moe
    from repro_torch.models.params import Ctx
    ctx = Ctx(SEED, "float32", dev)
    init_moe(ctx.sub("moe"), cfg)
    return ctx.params


def grouped_check(smi, dev, peak_bw, gm) -> dict:
    """(a) the three kernels against their plain versions in fp32 and bf16
    (fp32 weights; the edge cases also with bf16 weights) at the
    published expert shapes of deepseek-v2 (E 160,
    d_model 5,120, d_ff_expert 1,536, top-6) and llama4-scout (E 16,
    d_model 5,120, d_ff_expert 8,192, top-1), for the gate's (and up's)
    weights (K d_model, N d_ff_expert) and the down projection's (K
    d_ff_expert, N d_model), routed by each arch's router on seed-0
    weights for batch A's prefill (2,048 tokens) and a decode step (4),
    then the edge cases at each shape; each routed case timed. Returns the
    kernels line's rows and deepseek-v2's layer params (for
    ``moe_layer_full``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    rows, keep = {}, None
    # the registers and spills of every kernel of the library, from the
    # build's ptxas -v (the parent process's build, or gm.library()'s)
    ptxas = ptxas_summary((build.BUILD_DIR / "grouped_mm.log").read_text())
    for arch in (SCOUT, DEEPSEEK):
        cfg = get_config(arch)
        p = moe_params(cfg, dev)
        routed = {}
        for tokens in (t for a, t in GROUPED_TOKENS if a == arch):
            gen.manual_seed(SEED)
            routed[tokens] = routed_rows(cfg, p, tokens, gen, dev)
        for weight in GROUPED_WEIGHTS:
            w = p[f"moe/{weight}"]
            e, k, n = w.shape
            for tokens, (h, offs) in routed.items():
                gen.manual_seed(SEED)
                # the gate's rows are the routed hidden states; the down
                # projection's are d_ff_expert wide, on the same routing
                x32 = h if weight == "w_gate" else torch.randn(
                    (h.shape[0], k), generator=gen, device=dev)
                dy32 = torch.randn((x32.shape[0], n), generator=gen,
                                   device=dev)
                lib, why = grouped_library(x32.to(BF16), w,
                                           dy32.to(BF16), offs)
                emit({"phase": "grouped_geometry", "arch": arch,
                      "weight": weight, "tokens": tokens,
                      "rows": x32.shape[0], "w_dtype": "float32",
                      "sms": gm.sm_count(dev.index),
                      **grouped_geometry(gm, x32.to(BF16), w,
                                         dy32.to(BF16), ptxas)})
                for dt in ("float32", "bfloat16"):
                    x, dy = (x32.to(getattr(torch, dt)),
                             dy32.to(getattr(torch, dt)))
                    errs = grouped_case(gm, x, w, dy, offs)
                    t = grouped_times(gm, x, w, dy, offs, peak_bw,
                                      lib if dt == "bfloat16" else {})
                    emit({"phase": "grouped_check", "arch": arch,
                          "weight": weight, "E": e, "K": k, "N": n,
                          "top_k": cfg.moe.top_k, "tokens": tokens,
                          "rows": x.shape[0], "dtype": dt,
                          "w_dtype": "float32",
                          "active_experts": t.pop("active_experts"),
                          "errors": errs, "times": t,
                          "library": "torch._grouped_mm, bf16 x and w; "
                          "library_cast: w.to(bf16) then that call"
                          if dt == "bfloat16" else None,
                          "library_refused": why if dt == "bfloat16"
                          else {}, "nvidia_smi": smi})
                    if (arch, tokens, dt, weight) == GROUPED_MAIN:
                        rows = {name: {**t[name], "max_abs_err":
                                       errs[name]["max_abs_err"]}
                                for name in GROUPED_KERNELS}
            # the edge cases with the fp32 weights and with their bf16
            # copy (the kernels' bf16-weight instantiations)
            for wt in (w, w.to(BF16)):
                for case, offs in edge_offsets(e, dev).items():
                    gen.manual_seed(SEED)
                    r = int(offs[-1])
                    tail = EDGE_NAN_ROWS if case == "nan_outside" else 0
                    for dt in (FP32, BF16):
                        x = torch.randn((r + tail, k), generator=gen,
                                        device=dev).to(dt)
                        dy = torch.randn((r + tail, n), generator=gen,
                                         device=dev).to(dt)
                        x[r:] = float("nan")
                        dy[r:] = float("nan")
                        emit({"phase": "grouped_check", "arch": arch,
                              "weight": weight, "case": case, "E": e,
                              "K": k, "N": n, "rows": r + tail,
                              "dtype": str(dt).replace("torch.", ""),
                              "w_dtype": str(wt.dtype).replace("torch.",
                                                               ""),
                              "errors": grouped_case(gm, x, wt, dy,
                                                     offs)})
            del w
        del routed
        if arch == DEEPSEEK:
            keep = p
        del p
        torch.cuda.empty_cache()
    emit({"phase": "grouped_check_done",
          "seconds": time.perf_counter() - t0})
    return rows, keep


def moe_layer_full(smi, dev, p, gm) -> dict:
    """(c) one deepseek-v2 ``apply_moe`` layer at published widths (top-6
    of 160 experts, 2 shared; bf16 compute, fp32 params) on 4 × 512
    tokens, forward and backward (the input's and every parameter's
    gradient) eager, then captured in a CUDA graph and replayed: outputs
    and gradients ``torch.equal``; the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import apply_moe
    cfg = get_config(DEEPSEEK).replace(dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b, t = MOE_LAYER_TOKENS
    x = torch.randn((b, t, cfg.d_model), generator=gen, device=dev).to(BF16)
    probe = torch.randn((b, t, cfg.d_model), generator=gen, device=dev)
    leaves = [x.requires_grad_(), *(v.requires_grad_() for v in p.values())]

    def step():
        # the outputs detached: a graph kept alive would keep the leaves'
        # gradient accumulators of the eager run's stream into the capture
        out, aux = apply_moe(cfg, p, x, prefix="moe")
        loss = (out.float() * probe).sum() + aux
        grads = torch.autograd.grad(loss, leaves)
        return (out.detach(), aux.detach(), *grads)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gm.reset_launches()
    eager = step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(gm.LAUNCHES)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    replay_ms = time_ms(graph.replay, 3)
    unequal = sum(int((a != c).sum()) for a, c in zip(eager, captured))
    res = {"phase": "moe_layer_full", "arch": DEEPSEEK, "tokens": [b, t],
           "E": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "n_shared": cfg.moe.n_shared, "dtype": "bfloat16",
           "param_dtype": "float32",
           "params": sum(int(v.numel()) for v in p.values()),
           "eager_ms": eager_ms, "capture_and_replay_ms": capture_ms,
           "replay_ms": replay_ms, "unequal_elements": unequal,
           "tensors_compared": len(eager), "launches_eager": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "nvidia_smi": smi}
    emit(res)
    assert unequal == 0, res
    assert all(launches[k] == 3 for k in GROUPED_KERNELS), launches
    assert all(bool(torch.isfinite(v.float()).all()) for v in eager), res
    return res


def moe_chunks(smi, gm) -> dict:
    """(b) reduced deepseek-v2, llama4-scout and jamba-1.5 through
    ``launch/train.py --algo quafl --scan-chunk 2 --steps 4`` and reduced
    deepseek-v2 through ``--algo spmd`` over the NCCL group of one, each
    chunked run against its eager run under ``sync_debug("error")``:
    engine ``scanned``, the final state equal, bits exact every round, the
    grouped kernels launched (counts from 0 just before, read just
    after)."""
    import torch.distributed as dist
    from repro_torch.fed.engine import sync_debug
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_size
    t0 = time.perf_counter()
    runs = [(arch, "quafl") for arch in MOE_CHUNK_ARCHS] + [(DEEPSEEK,
                                                             "spmd")]
    gm.reset_launches()
    res = {"phase": "moe_chunks", "sync_debug": "error", "runs": {},
           "nvidia_smi": smi}
    nccl_group_of_one()
    try:
        for arch, algo in runs:
            argv = ["--arch", arch, "--algo", algo] + MOE_CHUNK_ARGV
            with sync_debug("error"):
                eager = train.main(argv)
                chunked = train.main(argv + ["--scan-chunk", "2"])
            torch.cuda.synchronize()
            a, b = eager.trace, chunked.trace
            if algo == "spmd":
                unequal = spmd_states_equal(a.final_state, b.final_state)
            else:
                unequal = int((a.final_state.server
                               != b.final_state.server).sum())
                d = tree_size(eager.alg.eval_params(a.final_state))
                for r in a.rows + b.rows:
                    assert (r["bits_up"], r["bits_down"]) == bits_a_round(
                        algo, d, r), (arch, r)
            same = all(ra[f] == rb[f] for ra, rb in zip(a.rows, b.rows)
                       for f in ("bits_up", "bits_down", "sim_time"))
            res["runs"][f"{arch}/{algo}"] = {
                "engine": b.engine, "rounds": b.rounds,
                "unequal": unequal, "rows_equal": same,
                "server_loss": [r["server_loss"] for r in b.rows],
                "us_per_round": [a.us_per_round, b.us_per_round]}
            assert b.engine == "scanned" and unequal == 0 and same, \
                (arch, algo, res["runs"][f"{arch}/{algo}"])
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    res["launches"] = dict(gm.LAUNCHES)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    for k in GROUPED_KERNELS:
        assert res["launches"][k] > 0, (k, res["launches"])
    return res


def moe_phases() -> int:
    """``chip_smoke.py --moe``, in a process of its own: ``grouped_check``,
    ``moe_chunks`` (the path: counts from 0 just before, read just after)
    and ``moe_layer_full``; then the grouped kernels' rows of the kernels
    line (``moe_kernels``)."""
    from repro_torch.kernels import grouped_mm as gm
    smi = smi_line()
    dev = torch.device("cuda", 0)
    peak_bw = peak_bytes_per_s(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    assert not torch.backends.cuda.matmul.allow_tf32   # plain fp32: no TF32
    gm.library()
    rows, p = grouped_check(smi, dev, peak_bw, gm)
    moe_layer_full(smi, dev, p, gm)
    del p
    torch.cuda.empty_cache()
    chunks = moe_chunks(smi, gm)
    emit({"phase": "moe_kernels", "nvidia_smi": smi, "kernels": {
        k: {**rows[k], "launches": chunks["launches"][k]}
        for k in GROUPED_KERNELS}})
    emit({"phase": "moe_process", "seconds": time.perf_counter() - t0})
    return 0


def run_moe() -> dict:
    """``chip_smoke.py --moe`` in a process of its own, its lines relayed;
    its wall gated at ``MOE_BUDGET``. Returns the grouped kernels' rows."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--moe"], capture_output=True, text=True,
                          timeout=MOE_TIMEOUT)
    seconds = time.perf_counter() - t0
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise RuntimeError(f"the moe phases exited {proc.returncode}")
    emit({"phase": "moe_wall", "seconds": seconds, "budget": MOE_BUDGET})
    assert seconds <= MOE_BUDGET, (seconds, MOE_BUDGET)
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith('{"phase": "moe_kernels"')]
    assert len(lines) == 1, "the moe process printed no kernels line"
    return lines[0]["kernels"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--train-full"]:
        return train_full()
    if sys.argv[1:] == ["--spmd"]:
        return spmd_phases()
    if sys.argv[1:] == ["--zoo"]:
        return zoo_phases()
    if sys.argv[1:] == ["--population"]:
        return population_phases()
    if sys.argv[1:] == ["--encdec"]:
        return encdec_phases()
    if sys.argv[1:] == ["--tools"]:
        return tools_phases()
    if sys.argv[1:] == ["--analysis"]:
        return analysis_phases()
    if sys.argv[1:] == ["--moe"]:
        return moe_phases()
    from repro_torch import default_device
    from repro_torch.fed.engine import clone_tree
    from repro_torch.kernels import build
    from repro_torch.kernels import exchange as kx
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_mm as gm
    from repro_torch.kernels import hadamard as hd
    from repro_torch.kernels import lattice_quant as lq
    from repro_torch.kernels import ops

    t_script = time.perf_counter()
    dev = default_device()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    peak_bw = peak_bytes_per_s(name)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "peak_bytes_per_s": peak_bw})
    print(smi, flush=True)

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    names = ("exchange", "flash_attention", "flash_wgmma", "hadamard",
             "lattice_quant", "grouped_mm")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build.build, names)))
    for module in (kx, fa, hd, lq, gm):
        module.library()
    # ptxas -v names no dynamic shared memory: the bf16 flash kernel's, a
    # CTA of each instantiation, from its own plan
    wgmma_smem = {f"flash_wgmma_kernel<{dh}>":
                  fa.library(BF16).flash_wgmma_smem_bytes(dh)
                  for dh in fa.HEAD_DIMS}
    for lib_name, (path, nvcc_s, log) in built.items():
        ptxas = ptxas_summary(log)
        for fn, smem in wgmma_smem.items():
            for key in (fn, fn[:-1] + ",empty_rows>"):
                if key in ptxas:
                    ptxas[key] += (f"; {smem} bytes dynamic shared memory"
                                   " a CTA")
        emit({"phase": "build", "source": f"src/repro_torch/kernels/csrc/"
              f"{lib_name}.cu", "arch": "sm_90a",
              "flags": " ".join(build.NVCC_FLAGS),
              "seconds_all": time.perf_counter() - t0,
              "nvcc_seconds": nvcc_s,
              "library": str(path.relative_to(ROOT)),
              "ptxas": ptxas})

    # path 9, federated LM training at full width: its own process, with
    # the card's memory to itself (counts from 0 just before and read just
    # after, inside it)
    run_train_full()
    # path 10, the mesh train step: its own process, an NCCL group of one
    run_spmd()
    # path 11, the rest of the decoder zoo: its own process
    run_zoo()
    # path 12, the split population store and the mesh serving steps: its
    # own process, an NCCL group of one
    run_population()
    # path 13, the encoder-decoder and frontend archs through the mesh
    # steps: its own process, an NCCL group of one
    run_encdec()
    # path 14, the dry-run tools, the shard_map MoE and the op budgets:
    # its own process, an NCCL group of one
    run_tools()
    # path 15, the invariant gate over the whole matrix, captured chunks
    # under the sync-debug mode: its own process, an NCCL group of one
    run_analysis()
    # path 16, the MoE's grouped product: its kernels against their plain
    # versions, MoE training in captured chunks, a full-width layer
    # captured: its own process
    grouped = run_moe()

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    checks = [(BENCH_M, BENCH_D, 8, 1, None), (BENCH_M, BENCH_D, 4, 2, None),
              (4, 4096, 8, 1, None), (4, 4096, 4, 2, None),
              (4, 8192, 8, 1, None), (4, 8192, 4, 2, None),
              (4, 4096, 8, 1, [256.0, 16.0, 64.0, 256.0]),
              (S, 32_768, 8, 1, None), (S, 32_768, 4, 2, None),
              (S, 32_768, 8, 1, GROUPED_LEVELS),
              # adaptive_quafl's unpacked widths (int32 codes): the widths
              # its main path settles at, and the widest
              (S, 32_768, 10, 1, None), (S, 32_768, 11, 1, None),
              (S, 32_768, 12, 1, None), (S, 32_768, 16, 1, None)]
    timings = {}
    errors = {k: 0.0 for k in REPLACES}
    for m, d_pad, bits, pack, levels in checks:
        res, io = kernel_cases(kx, dev, gen, m, d_pad, bits, pack, levels)
        emit({"phase": "kernel_check", **res})
        if (m, d_pad, bits, pack, levels) in ((BENCH_M, BENCH_D, 8, 1, None),
                                              (S, 32_768, 8, 1, None)):
            main_shape = d_pad == 32_768
            t = time_kernels(kx, io, m, d_pad, bits, pack, peak_bw)
            emit({"phase": "kernel_times", "m": m, "d_pad": d_pad,
                  "bits": bits, "pack": pack, "nvidia_smi": smi,
                  "kernels": t})
            if main_shape:
                timings = t
                errors = {"fused_rotate": res["rotate_rel_err"],
                          "fused_encode": float(res["encode_max_gap"]),
                          "quantize_codes": float(res["quantize_max_gap"]),
                          "snap_codes": res["snap_max_abs_err"]}
        del io
        torch.cuda.empty_cache()

    # fused_decode (and fused_encode with per-message sign rows) against
    # the plain versions; the (S, 32,768) sign-row case is compressed
    # FedAvg's uplink, the (1, 32,768) one a FedBuff delta
    decode_checks = [
        (BENCH_M, BENCH_D, 8, 1, {}),
        (4, 4096, 4, 2, {}),
        (4, 8192, 8, 1, {"mr": 4, "sign_rows": True}),
        (4, 4096, 8, 1, {"mr": 4, "levels": [256.0, 16.0, 64.0, 256.0]}),
        (S, 32_768, 8, 1, {"sign_rows": True}),
        (1, 32_768, 8, 1, {"sign_rows": True}),
        (S, 32_768, 8, 1, {"levels": GROUPED_LEVELS}),
        # b=12 unpacked, and quafl_scaffold's controls: s messages, each
        # with its own sign row, against s references
        (S, 32_768, 12, 1, {"sign_rows": True}),
        (S, 32_768, 8, 1, {"mr": S, "sign_rows": True})]
    decode_times = {}
    for m, d_pad, bits, pack, kw in decode_checks:
        res, io = decode_case(kx, dev, gen, m, d_pad, bits, pack, **kw)
        emit({"phase": "kernel_check", "kernel": "fused_decode", **res})
        if d_pad == 32_768:
            errors["fused_decode"] = max(errors.get("fused_decode", 0.0),
                                         res["decode_max_abs_err"])
        if (m, d_pad) in ((BENCH_M, BENCH_D), (S, 32_768), (1, 32_768)) \
                and bits == 8 and not {"levels", "mr"} & set(kw):
            decode_times[(m, d_pad)] = time_decode(kx, io, peak_bw)
            emit({"phase": "kernel_times", "m": m, "d_pad": d_pad,
                  "bits": bits, "pack": pack, "nvidia_smi": smi,
                  "kernels": {"fused_decode": decode_times[(m, d_pad)]}})
        del io
        torch.cuda.empty_cache()
    timings["fused_decode"] = decode_times[(S, 32_768)]

    # flash attention against its plain version at the serve path's shapes
    for label, b, t, h, kv, dh, window, cap, dtype in FLASH_CASES:
        res, (q, k, v) = flash_case(fa, dev, gen, b, t, h, kv, dh, window,
                                    cap, dtype)
        emit({"phase": "flash_check", "case": label, **res})
        if label.startswith("gemma2_") and dtype == BF16:
            errors["flash_attention"] = max(errors.get("flash_attention", 0.0),
                                            res["max_abs_err"])
        if label in FLASH_TIMED:
            ft = time_flash(fa, q, k, v, window, cap, peak_bw)
            emit({"phase": "flash_times", "case": label, "nvidia_smi": smi,
                  **ft})
            if label == FLASH_MAIN:
                timings["flash_attention"] = ft
                emit({"phase": "flash_times", "case": f"{label}_softcap0",
                      "nvidia_smi": smi,
                      **time_flash(fa, q, k, v, window, 0.0, peak_bw)})
        del q, k, v
        torch.cuda.empty_cache()

    # the kernels' public API: each kernel against its plain version, then
    # path 4, the API as a user calls it (counts from 0 just before, read
    # just after), then its times
    errors.update(ops_checks(hd, lq, dev, gen))
    hd.reset_launches()
    lq.reset_launches()
    run_ops_path(ops, kx, dev, gen)
    torch.cuda.synchronize()
    ops_launches = {**hd.LAUNCHES, **lq.LAUNCHES}
    emit({"phase": "launches", "path": "ops", "launches": ops_launches})
    n_sizes = len(OPS_SIZES)
    assert ops_launches == {"hadamard_blocks": 3 * n_sizes,
                            "lattice_encode": n_sizes,
                            "lattice_decode": n_sizes}, ops_launches
    ops_times = time_ops(hd, lq, dev, gen, peak_bw)
    emit({"phase": "ops_times", "d": BENCH_M * BENCH_D, "nvidia_smi": smi,
          "kernels": ops_times})
    for k in OPS_SYMBOLS:
        timings[k] = {f: v for f, v in ops_times[k].items()
                      if f != "device_ms"}
    torch.cuda.empty_cache()

    # path 1, QuAFL: counts from 0 just before, read just after
    kx.reset_launches()
    runs = {}
    for uplink, bits_up in (("lattice", 4_194_816),
                            ("lattice_packed:bits=4", 2_097_664)):
        alg, tr, acc0, wall, data = run_main_path(dev, uplink)
        emit({"phase": "main_path", "uplink": uplink, "rounds": tr.rounds,
              "d": alg.d, "n_clients": N_CLIENTS, "s": S,
              "bits_up": tr.column("bits_up"),
              "bits_down": tr.column("bits_down"),
              "quant_err_final": tr.final["quant_err"], "acc_round0": acc0,
              "acc": [(r["round"], r["acc"]) for r in tr.rows if "acc" in r],
              "seconds": wall, "ms_per_round": wall / tr.rounds * 1e3,
              "rotations": alg.pipeline.stats.counts()})
        check_main_path(tr, acc0, bits_up, 262_176)
        assert alg.pipeline.stats.counts() == {
            "rotation_fwd": ROUNDS * (S + 1), "rotation_inv": ROUNDS * (S + 1)}
        runs[uplink] = (alg, tr, data)
    torch.cuda.synchronize()
    quafl_launches = dict(kx.LAUNCHES)
    emit({"phase": "launches", "path": "quafl", "launches": quafl_launches})
    for k in ("fused_encode", "fused_rotate", "quantize_codes", "uplink",
              "average"):
        assert quafl_launches[k] > 0, f"kernel {k} never launched on QuAFL"

    # path 2, the baselines: counts from 0 just before, read just after
    kx.reset_launches()
    b_algs, b_traces, b_base, b_data, b_gen = run_baselines(dev, kx)
    torch.cuda.synchronize()
    base_launches = dict(kx.LAUNCHES)
    emit({"phase": "launches", "path": "baselines",
          "launches": base_launches})
    check_baselines(b_algs, b_traces, b_base)
    for k in ("fused_encode", "fused_decode"):
        assert base_launches[k] > 0, f"kernel {k} never launched on the " \
            f"baselines"
    launches = {**quafl_launches, "fused_decode": base_launches["fused_decode"]}

    alg, tr, data = runs["lattice"]
    diff, step, _ = injected_round(dev, alg, tr.final_state, data, gen)
    emit({"phase": "injected_round", "algorithm": "quafl",
          "max_abs_diff": diff, "lattice_step": step})
    assert diff <= step, (diff, step)
    cfa = b_algs["compressed_fedavg"].alg
    cfa_state = b_traces["compressed_fedavg"].final_state
    diff, step = injected_cfa_round(dev, cfa, cfa_state, b_data, b_gen)
    emit({"phase": "injected_round", "algorithm": "compressed_fedavg",
          "max_abs_diff": diff, "lattice_step": step})
    assert diff <= step, (diff, step)

    prof = profile_rounds(alg, clone_tree(tr.final_state), data, gen)
    emit({"phase": "profile", "algorithm": "quafl", "uplink": "lattice",
          "nvidia_smi": smi, **prof})
    device_ms = prof["ported_device_ms_per_launch"]
    for run in ("compressed_fedavg", "fedbuff_lattice"):
        p = profile_rounds(b_algs[run].alg, b_traces[run].final_state,
                           b_data, b_gen, rounds=3)
        emit({"phase": "profile", "algorithm": run, **p})
        if run == "compressed_fedavg":
            device_ms["fused_decode"] = p["ported_device_ms_per_launch"][
                "fused_decode"]

    # path 5, QuAFL's grouped uplink, participation specs and per-message
    # branch: each run's counts from 0 just before, read just after (inside
    # run_variants); one pipeline run of path 1 is its launch yardstick
    variants = run_variants(dev, kx, {k: v // 2
                                      for k, v in quafl_launches.items()})
    g_alg, g_tr, g_data = variants["grouped"]
    ids = torch.cat([torch.randperm(N_SLOW, generator=gen, device=dev)[:5],
                     N_SLOW + torch.randperm(N_CLIENTS - N_SLOW,
                                             generator=gen,
                                             device=dev)[:S - 5]])
    diff, step, detail = injected_round(dev, g_alg, g_tr.final_state,
                                        g_data, gen, idx=ids)
    res = {"phase": "injected_round", "algorithm": "quafl",
           "uplink": "grouped", "slow_clients": 5, "max_abs_diff": diff,
           "lattice_step": step, "gam_up": detail["gam_up"],
           "gam_dn": detail["gam_dn"]}
    res.update(check_grouped_round(detail, S))
    emit(res)
    assert diff <= step, (diff, step)
    for run in ("grouped", "per_message"):
        v_alg, v_tr, v_data = variants[run]
        p = profile_rounds(v_alg, clone_tree(v_tr.final_state), v_data, gen)
        emit({"phase": "profile", "algorithm": "quafl", "run": run,
              "uplink": str(v_alg.uplink), "nvidia_smi": smi, **p})

    # path 7, the extensions: quafl_scaffold and adaptive_quafl, each run's
    # counts from 0 just before and read just after (inside run_scaffold
    # and run_adaptive), SCAFFOLD's injected round and its profile; then
    # the top-k EF invariant on one compressed_fedavg round of path 2
    sc_alg, sc_tr, sc_data, sc_launches = run_scaffold(dev, kx)
    injected_scaffold_round(dev, sc_alg, sc_tr.final_state, sc_data, gen)
    p = profile_rounds(sc_alg, clone_tree(sc_tr.final_state), sc_data, gen)
    emit({"phase": "profile", "algorithm": "quafl_scaffold",
          "nvidia_smi": smi, **p})
    run_adaptive(dev, kx)
    injected_ef_round(dev, b_algs["compressed_fedavg_topk_ef"].alg,
                      b_traces["compressed_fedavg_topk_ef"].final_state,
                      b_data, b_gen)

    # path 8, the round engine: every device algorithm eager and in
    # chunks captured as CUDA graphs (counts from 0 just before, read just
    # after, inside run_engine), then fedbuff_device against fedbuff
    run_engine(dev, kx, smi)

    # path 9 at reduced width: every registry algorithm through
    # launch/train.py (counts from 0 just before, read just after, inside
    # run_train_reduced), the chunked LM run, a checkpoint
    run_train_reduced(kx)

    # path 6, the quickstart through compare (counts from 0 just before,
    # read just after, inside run_quickstart), then the three twins as CLIs
    run_quickstart(dev, kx)
    run_twin_clis()

    # path 3, LM serving: counts from 0 just before, read just after
    # (inside run_serve_path)
    launches["flash_attention"], prof_b = run_serve_path(dev, smi, fa)
    emit({"phase": "launches", "path": "serve",
          "launches": {"flash_attention": launches["flash_attention"]}})
    assert launches["flash_attention"] > 0
    device_ms["flash_attention"] = prof_b["flash_device_ms_per_launch"]
    run_serve_cli(fa)
    launches.update(ops_launches)
    device_ms.update({k: ops_times[k]["device_ms"] for k in OPS_SYMBOLS})

    emit({"phase": "script", "seconds": time.perf_counter() - t_script})
    emit({"kernels": [dict(name=k, route="cuda", source=SOURCES[k],
                           replaces=REPLACES[k], launches=launches[k],
                           max_abs_err=errors[k], **timings[k],
                           device_ms=device_ms[k])
                      for k in REPLACES]
          + [dict(name=k, route="cuda", source=CSRC + "grouped_mm.cu",
                  replaces=GROUPED_REPLACES, **grouped[k])
             for k in GROUPED_KERNELS]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
