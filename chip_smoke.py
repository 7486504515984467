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
  compressed FedAvg (lattice and scalar uplinks), FedBuff (lattice and qsgd
  deltas) and the sequential node, 30 rounds each;
* QuAFL's other paths at the same width, 30 rounds each: the grouped
  per-client uplink (fast clients at b=8, the slow 30% charged b=4, a
  per-message levels row through the encode and the snap), the
  ``cyclic`` and ``gamma_straggler`` participation specs, and the
  per-message branch (a ``scalar`` uplink, the lattice downlink through the
  codec API); every round's bits exact from its sampled ids;
* the quickstart: its four runs (``quafl``, ``quafl_het``, ``fedavg``,
  ``fedpaq``) through ``compare`` at the same width and an equal simulated
  time, then ``python -m repro_torch.examples.quickstart`` and
  ``...heterogeneous_clients`` as a user runs them, each in a subprocess;
* LM serving of gemma2-2b at full width (26 layers, random weights from
  seed 0) through ``ServeEngine``: two batches of four prompts (longest 512
  and 4,608 tokens), 32 greedy tokens each, twice, then one batch sampled
  at temperature 0.8; every prefill attention on the bf16 tensor-core
  flash-attention kernel (``csrc/flash_wgmma.cu``). Then a prefill/decode
  consistency check in fp32 (the CUDA-core flash kernel) and bf16, and the
  serve CLI (``repro_torch.launch.serve --full``) once.

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

def clone_state(state):
    from repro_torch.core.quafl import QuaflState
    from repro_torch.fed.population import Population
    return QuaflState(
        server=state.server.clone(),
        pop=Population(rows={k: v.clone() for k, v in state.pop.rows.items()}),
        t=state.t, sim_time=state.sim_time, bits_up=state.bits_up,
        bits_down=state.bits_down, srv_dist_est=state.srv_dist_est.clone())


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


def run_main_path(dev, uplink, participation=None):
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import simulate
    from repro_torch.models.mlp import mlp_loss, mlp_loss_batched
    fed, part, test, p0, gen = chip_world(dev)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched, template=p0,
                         batch_size=32, uplink=uplink,
                         participation=participation, device=dev)
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
        st, _ = alg.round(clone_state(state), data, None, draws=draws)
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


class GammaLog:
    """A codec that records the largest γ of every message it encodes."""

    def __init__(self, codec):
        self.codec = codec
        self.gammas = [0.0]

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def encode(self, key, x, hint=None):
        msg = self.codec.encode(key, x, hint)
        self.gammas.append(float(msg.gamma.max()))
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
        alg.codec_up = GammaLog(codec)
        st, _ = alg.round(state, data, None, draws=draws)
        steps.append(max(alg.codec_up.gammas))
        alg.codec_up = codec
        servers.append(st.server)
    return float((servers[0] - servers[1]).abs().max()), max(steps)


KERNEL_SYMBOLS = {"fused_encode": "encode_cluster_kernel",
                  "fused_rotate": "rotate_cluster_kernel",
                  "quantize_codes": "quantize_vec_kernel",
                  "snap_codes": "snap_vec_kernel",
                  "fused_decode": "decode_cluster_kernel"}


def device_events(prof):
    """The profiler's averages of the kernels that ran on the card."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def ms_per_launch(kernels, symbols: dict) -> dict:
    """Mean device ms per launch of each named kernel (None if it never
    ran), from ``device_events``; ``symbols`` maps names to a substring of
    the kernel's symbol."""
    out = {}
    for name, sym in symbols.items():
        hits = [e for e in kernels if sym in e.key]
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
    for k in ("fused_encode", "fused_rotate", "quantize_codes",
              "snap_codes"):
        assert launches[k] > 0, f"kernel {k} never launched on the " \
            f"quickstart"
    h, q = traces["quafl_het"].final, traces["quafl"].final
    assert q["bits_up_total"] / h["bits_up_total"] > 1.0
    return rows


def run_twin_clis():
    """``python -m repro_torch.examples.quickstart`` and
    ``...heterogeneous_clients`` as a user runs them, each in its own
    process on the card; their printed lines, the quickstart's table and
    both heterogeneous-uplink ratios above 1."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for name in ("quickstart", "heterogeneous_clients"):
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
]
FLASH_TIMED = ("gemma2_A_global", "gemma2_A_local", "gemma2_B_global",
               "gemma2_B_local")
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
                               t_pre=512):
    """Logits of a kernel prefill of t tokens against a kernel prefill of
    t_pre plus t - t_pre teacher-forced decode steps (plain sdpa over the
    cache): (max |Δ|, max |logit|, flash launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import decode_step, forward, init_cache
    c = cfg.replace(dtype=dtype)
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(1, c.vocab_size, (b, t))).to(dev)
    fa.reset_launches()
    full, _, _ = forward(c, params, {"tokens": toks})
    want = full[:, t_pre:].clone()
    del full
    cache = init_cache(c, b, t, dev)
    _, cache, _ = forward(c, params, {"tokens": toks[:, :t_pre]}, cache=cache)
    err = 0.0
    for i in range(t - t_pre):
        lg, cache = decode_step(c, params, toks[:, t_pre + i:t_pre + i + 1],
                                t_pre + i, cache)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import default_device
    from repro_torch.kernels import build
    from repro_torch.kernels import exchange as kx
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hadamard as hd
    from repro_torch.kernels import lattice_quant as lq
    from repro_torch.kernels import ops

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
             "lattice_quant")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build.build, names)))
    for module in (kx, fa, hd, lq):
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    checks = [(BENCH_M, BENCH_D, 8, 1, None), (BENCH_M, BENCH_D, 4, 2, None),
              (4, 4096, 8, 1, None), (4, 4096, 4, 2, None),
              (4, 8192, 8, 1, None), (4, 8192, 4, 2, None),
              (4, 4096, 8, 1, [256.0, 16.0, 64.0, 256.0]),
              (S, 32_768, 8, 1, None), (S, 32_768, 4, 2, None),
              (S, 32_768, 8, 1, GROUPED_LEVELS)]
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
        (S, 32_768, 8, 1, {"levels": GROUPED_LEVELS})]
    decode_times = {}
    for m, d_pad, bits, pack, kw in decode_checks:
        res, io = decode_case(kx, dev, gen, m, d_pad, bits, pack, **kw)
        emit({"phase": "kernel_check", "kernel": "fused_decode", **res})
        if d_pad == 32_768:
            errors["fused_decode"] = max(errors.get("fused_decode", 0.0),
                                         res["decode_max_abs_err"])
        if (m, d_pad) in ((BENCH_M, BENCH_D), (S, 32_768), (1, 32_768)) \
                and "levels" not in kw:
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
    for k in ("fused_encode", "fused_rotate", "quantize_codes", "snap_codes"):
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

    prof = profile_rounds(alg, clone_state(tr.final_state), data, gen)
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
        p = profile_rounds(v_alg, clone_state(v_tr.final_state), v_data, gen)
        emit({"phase": "profile", "algorithm": "quafl", "run": run,
              "uplink": str(v_alg.uplink), "nvidia_smi": smi, **p})

    # path 6, the quickstart through compare (counts from 0 just before,
    # read just after, inside run_quickstart), then its two twins as CLIs
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

    emit({"kernels": [dict(name=k, route="cuda", source=SOURCES[k],
                           replaces=REPLACES[k], launches=launches[k],
                           max_abs_err=errors[k], **timings[k],
                           device_ms=device_ms[k])
                      for k in REPLACES]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
