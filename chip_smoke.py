#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout: builds the CUDA kernels of
``src/repro_torch/kernels/csrc/`` with nvcc, holds each kernel against its
plain PyTorch version on the card and times both, then drives the port's
main path — QuAFL (paper Algorithm 1) through ``make_algorithm`` and
``simulate`` at the paper's MLP width (784-32-10, n=300 clients, s=16) —
once with the 8-bit ``lattice`` codec and once with a ``lattice_packed:
bits=4`` uplink. It prints JSON lines per phase, a ``kernels`` line, the
card's name and power limit, and last ``{"ok": true, "device": ...}``.

Every check raises on failure, so any failed phase exits non-zero; so does a
machine without CUDA. The port imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
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


KERNEL_SYMBOLS = {"fused_encode": "encode_kernel",
                  "fused_rotate": "rotate_kernel",
                  "quantize_codes": "quantize_kernel",
                  "snap_codes": "snap_kernel"}


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
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
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

    # the main path: counts from 0 just before, read just after
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
    launches = dict(kx.LAUNCHES)
    emit({"phase": "launches", "launches": launches})
    for k, v in launches.items():
        assert v > 0, f"kernel {k} never launched on the main path"

    alg, tr, data = runs["lattice"]
    diff, step = injected_round(dev, alg, tr.final_state, data, gen)
    emit({"phase": "injected_round", "max_abs_diff": diff,
          "lattice_step": step})
    assert diff <= step, (diff, step)

    prof = profile_rounds(alg, clone_state(tr.final_state), data, gen)
    emit({"phase": "profile", "uplink": "lattice", **prof})
    device_ms = prof["ported_device_ms_per_launch"]

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
