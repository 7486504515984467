#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout: builds the CUDA kernels of
``src/repro_torch/kernels/csrc/`` with nvcc, holds each kernel against its
plain PyTorch version on the card and times both, then drives the port's
two paths at the paper's MLP width (784-32-10, n=300 clients, s=16):

* QuAFL (paper Algorithm 1) through ``make_algorithm`` and ``simulate``,
  once with the 8-bit ``lattice`` codec and once with a ``lattice_packed:
  bits=4`` uplink;
* the paper's baselines through ``compare``: FedAvg, compressed FedAvg
  (lattice and scalar uplinks), FedBuff (lattice and qsgd deltas) and the
  sequential node, 30 rounds each.

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
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SOURCE = "src/repro_torch/kernels/csrc/exchange.cu"
REPLACES = {
    "fused_encode": "src/repro/kernels/exchange.py:322",
    "fused_rotate": "src/repro/kernels/exchange.py:266",
    "quantize_codes": "src/repro/kernels/exchange.py:371",
    "snap_codes": "src/repro/kernels/exchange.py:417",
    "fused_decode": "src/repro/kernels/exchange.py:464",
}
# fp32 operations per coordinate, for the operation bound: the butterfly's
# log2(b) adds plus the sign and scale multiplies; the quantize's div, add,
# floor, div, floor, mul and sub; the snap's div, sub, div, rint, mul, add
# and mul. Every kernel here is far below the card's ops/byte ridge.
QUANTIZE_OPS, SNAP_OPS = 7, 7
# device-memory rate by card name (NVIDIA data sheets); H100 SXM otherwise
PEAK_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                    ("H200", 4.8e12), ("H100", 3.35e12))
PEAK_FP32_OPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores

BENCH_M, BENCH_D = 32, 1 << 20    # benchmarks/bench_exchange.py's D_FULL
N_CLIENTS, S, K, LR, SWT, ROUNDS = 300, 16, 5, 0.3, 10.0, 30
SEED = 0                          # data, weights and draws of the main path
ROT_TOL = 1e-5                    # rotation: max err / max|y|
ENC_MISMATCH_FRAC = 1e-4          # encode: ±1 mod L on at most this share
DECODE_TOL = 1e-6                 # decode: max err / max|x| (target 0)
D_MLP = 25_450                    # 784-32-10: d_pad 32,768


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, ops: float, peak_bw: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = bytes_moved / peak_bw * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
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
           "levels": levels is not None}

    # rotation, both directions
    rot_err = 0.0
    for inverse in (False, True):
        yk = kx.fused_rotate(x, sg, inverse=inverse)
        yp = kx.rotate_plain(x, sg, inverse=inverse)
        rot_err = max(rot_err, float((yk - yp).abs().max()
                                     / yp.abs().max()))
    res["rotate_rel_err"] = rot_err
    assert rot_err <= ROT_TOL, res

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
    out = {}

    # fused_rotate: the inverse rotation of the s new client states
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
        shape=[m, d_pad])

    # fused_encode with y kept: the uplink of the s sampled clients
    eb, eby = bound(nbytes(x, sg, u, gam) + nbytes(y, codes),
                    n * (log_b + 2 + QUANTIZE_OPS), peak_bw)
    out["fused_encode"] = dict(
        ms=time_ms(lambda: kx.fused_encode(x, sg, u, gam, want_rotated=True,
                                           **kw)),
        plain_ms=time_ms(lambda: kx.encode_plain(x, sg, u, gam,
                                                 want_rotated=True, **kw)),
        bound_ms=eb, bound_by=eby, library_ms=None, shape=[m, d_pad])

    # quantize_codes: the downlink Enc(X_t), one message
    y1, u1, g1 = y[:1].contiguous(), u[:1].contiguous(), gam[:1].contiguous()
    c1 = kx.quantize_codes(y1, u1, g1, bits=bits, pack=pack)
    qb, qby = bound(nbytes(y1, u1, g1) + nbytes(c1), d_pad * QUANTIZE_OPS,
                    peak_bw)
    out["quantize_codes"] = dict(
        ms=time_ms(lambda: kx.quantize_codes(y1, u1, g1, bits=bits,
                                             pack=pack)),
        plain_ms=time_ms(lambda: kx.quantize_plain(y1, u1, g1, bits=bits,
                                                   pack=pack)),
        bound_ms=qb, bound_by=qby, library_ms=None, shape=[1, d_pad])

    # snap_codes: the uplink decode, m codes against the one rotated server
    w1 = w[:1].contiguous()
    s_out = kx.snap_codes(codes, w1, gam, bits=bits, pack=pack)
    sb, sby = bound(nbytes(codes, w1, gam) + nbytes(s_out), n * SNAP_OPS,
                    peak_bw)
    out["snap_codes"] = dict(
        ms=time_ms(lambda: kx.snap_codes(codes, w1, gam, bits=bits,
                                         pack=pack)),
        plain_ms=time_ms(lambda: kx.snap_plain(codes, w1, gam, bits=bits,
                                               pack=pack)),
        bound_ms=sb, bound_by=sby, library_ms=None, shape=[m, d_pad])
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
                plain_ms=time_ms(lambda: kx.decode_plain(codes, ref, sg, gam,
                                                         **kw)),
                bound_ms=db, bound_by=dby, library_ms=None,
                shape=[m, d_pad], ref_rows=int(ref.shape[0]),
                sign_rows=int(sg.dim() == 2))


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


def run_main_path(dev, uplink: str):
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_mlp import dims
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import simulate
    from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                        mlp_loss_batched)
    d_in, d_hidden, n_cls = dims()
    fed = FedConfig(n_clients=N_CLIENTS, s=S, local_steps=K, lr=LR, bits=8,
                    swt=SWT, kernel_backend="cuda")
    part, test = make_federated_classification(
        SEED, N_CLIENTS, d=d_in, n_classes=n_cls, iid=False,
        test_samples=4096, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    p0 = init_mlp_classifier(gen, d_in, d_hidden, n_cls)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched, template=p0,
                         batch_size=32, uplink=uplink, device=dev)

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
    for row in tr.rows:
        assert row["bits_up"] == bits_up, row
        assert row["bits_down"] == bits_down, row
    assert tr.final["bits_up_total"] == ROUNDS * bits_up
    final = tr.final["acc"]
    assert final > acc0 and final > 0.1, (acc0, final)


def injected_round(dev, alg_cuda, state, data, gen):
    """One round with the same injected draws on the cuda backend and on the
    torch backend; returns (max |Δ| of server and clients, lattice step)."""
    from repro_torch.compression.pipeline import round_randomness
    from repro_torch.fed.registry import make_algorithm
    fed_t = dataclasses.replace(alg_cuda.fed, kernel_backend="torch")
    alg_torch = make_algorithm("quafl", fed_t, loss_fn=alg_cuda.loss_fn,
                               template=alg_cuda.template, batch_size=32,
                               uplink=alg_cuda.uplink, device=dev)
    n, s = alg_cuda.fed.n_clients, alg_cuda.fed.s
    sg, u_cl, u_srv = round_randomness(gen, s, alg_cuda.d)
    draws = {"idx": torch.randperm(n, generator=gen, device=dev)[:s],
             "h_steps": torch.randint(0, K + 1, (s,), generator=gen,
                                      device=dev),
             "batch_idx": torch.randint(0, data["y"].shape[1], (s, K, 32),
                                        generator=gen, device=dev),
             "signs": sg, "u_cl": u_cl, "u_srv": u_srv}
    outs, steps = [], []
    for alg in (alg_cuda, alg_torch):
        seen = []
        inner = alg.pipeline.gammas

        def logged(*a, _inner=inner, _seen=seen, **k):
            g = _inner(*a, **k)
            _seen.append(g)
            return g
        alg.pipeline.gammas = logged
        st, _ = alg.round(clone_state(state), data, None, draws=draws)
        alg.pipeline.gammas = inner
        outs.append(st)
        steps.append(max(float(g.max()) for g in seen))
    a, b = outs
    diff = max(float((a.server - b.server).abs().max()),
               float((a.clients - b.clients).abs().max()))
    return diff, max(steps)


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
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_mlp import dims
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.fed.simulate import compare
    from repro_torch.models.mlp import (init_mlp_classifier, mlp_loss,
                                        mlp_loss_batched)
    d_in, d_hidden, n_cls = dims()
    fed = FedConfig(n_clients=N_CLIENTS, s=S, local_steps=K, lr=LR, bits=8,
                    swt=SWT, kernel_backend="cuda")
    part, test = make_federated_classification(
        SEED, N_CLIENTS, d=d_in, n_classes=n_cls, iid=False,
        test_samples=4096, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    p0 = init_mlp_classifier(gen, d_in, d_hidden, n_cls)
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


KERNEL_SYMBOLS = {"fused_encode": "encode_kernel",
                  "fused_rotate": "rotate_kernel",
                  "quantize_codes": "quantize_kernel",
                  "snap_codes": "snap_kernel",
                  "fused_decode": "decode_kernel"}


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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    per_launch = {}
    for name, sym in KERNEL_SYMBOLS.items():
        hits = [e for e in kernels if sym in e.key]
        count = sum(e.count for e in hits)
        per_launch[name] = (sum(e.self_device_time_total for e in hits)
                            / count / 1e3 if count else None)
    return {"rounds": rounds, "wall_ms_per_round": wall_us / rounds / 1e3,
            "device_ms_per_round": device_us / rounds / 1e3,
            "device_busy_share": device_us / wall_us,
            "kernel_launches_per_round": sum(e.count for e in kernels)
            / rounds,
            "top_kernels": [(e.key[:70], e.count // rounds,
                             e.self_device_time_total / rounds / 1e3)
                            for e in top],
            "ported_device_ms_per_launch": per_launch}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import default_device
    from repro_torch.kernels import build
    from repro_torch.kernels import exchange as kx

    dev = default_device()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    peak_bw = peak_bytes_per_s(name)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "peak_bytes_per_s": peak_bw})
    print(smi, flush=True)

    t0 = time.perf_counter()
    path, nvcc_s, log = build.build("exchange")
    kx.library()
    ptxas, fn = {}, None
    for ln in log.splitlines():
        hit = re.search(r"Compiling entry function '.*?([a-z]+_kernel)", ln)
        if hit:
            fn = hit.group(1)
        elif "registers" in ln and fn:
            ptxas[fn] = ln.split(":", 1)[1].strip()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": nvcc_s, "library": str(path.relative_to(ROOT)),
          "ptxas": ptxas})

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    checks = [(BENCH_M, BENCH_D, 8, 1, None), (BENCH_M, BENCH_D, 4, 2, None),
              (4, 4096, 8, 1, None), (4, 4096, 4, 2, None),
              (4, 8192, 8, 1, None), (4, 8192, 4, 2, None),
              (4, 4096, 8, 1, [256.0, 16.0, 64.0, 256.0]),
              (S, 32_768, 8, 1, None), (S, 32_768, 4, 2, None)]
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
        (1, 32_768, 8, 1, {"sign_rows": True})]
    decode_times = {}
    for m, d_pad, bits, pack, kw in decode_checks:
        res, io = decode_case(kx, dev, gen, m, d_pad, bits, pack, **kw)
        emit({"phase": "kernel_check", "kernel": "fused_decode", **res})
        if d_pad == 32_768:
            errors["fused_decode"] = max(errors.get("fused_decode", 0.0),
                                         res["decode_max_abs_err"])
        if (m, d_pad) in ((BENCH_M, BENCH_D), (S, 32_768), (1, 32_768)):
            decode_times[(m, d_pad)] = time_decode(kx, io, peak_bw)
            emit({"phase": "kernel_times", "m": m, "d_pad": d_pad,
                  "bits": bits, "pack": pack, "nvidia_smi": smi,
                  "kernels": {"fused_decode": decode_times[(m, d_pad)]}})
        del io
        torch.cuda.empty_cache()
    timings["fused_decode"] = decode_times[(S, 32_768)]

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
    diff, step = injected_round(dev, alg, tr.final_state, data, gen)
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
          **prof})
    device_ms = prof["ported_device_ms_per_launch"]
    for run in ("compressed_fedavg", "fedbuff_lattice"):
        p = profile_rounds(b_algs[run].alg, b_traces[run].final_state,
                           b_data, b_gen, rounds=3)
        emit({"phase": "profile", "algorithm": run, **p})
        if run == "compressed_fedavg":
            device_ms["fused_decode"] = p["ported_device_ms_per_launch"][
                "fused_decode"]

    emit({"kernels": [dict(name=k, route="cuda", source=SOURCE,
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
