#!/usr/bin/env python3
"""Device time a launch of the exchange kernels (``fused_rotate``,
``fused_encode``, ``quantize_codes``, ``snap_codes``, ``fused_decode``) at
each shape the federated paths launch them with and at the bench shape, of
the round's fused snaps (``uplink``, ``average``) at the two benchmark
cells' (s, d_pad), and of ``hadamard_blocks`` at the ``ops`` path's sizes,
from torch.profiler, and the ms of a wrapper call (CUDA events, host
overhead included, as ``chip_smoke.py``'s ``ms``):

    python3 chip_shapes.py [SRC]

SRC is the directory that holds the ``repro_torch`` package to time (this
checkout's ``src/`` by default). Pointed at an older commit's unpacked
``src/``, it times that commit's kernels, so two versions compare on one
card in one call. Each launch is also held ``torch.equal`` to its plain
version (the quantize also to ``fused_encode``'s codes), and each row
carries its byte bound. Where SRC's ``hadamard`` module takes a cluster
size, ``hadamard_blocks`` at (2,048, 128, 128) fp32 is also timed at each
cluster size its kernel takes, and where its ``exchange`` module takes a
count of outputs a thread, ``quantize_codes`` at the paths' shapes and 1 ×
2^20 at each count. Prints one JSON line per shape, then the card's name
and power limit; exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs           # puts this checkout's src/ on sys.path

# (kernel, messages, d_pad, bits, pack, what the path does with it); the
# snap's "down" rows are one code row against m references, "sign_rows" one
# sign row a message (a baseline's codec), "with_y" keeps the rotated y
SHAPES = (
    ("fused_rotate", 1, 32_768, 8, 1, "forward"),
    ("fused_rotate", 1, 32_768, 8, 1, "inverse"),
    ("fused_rotate", 16, 32_768, 8, 1, "inverse"),
    ("fused_rotate", cs.BENCH_M, cs.BENCH_D, 8, 1, "inverse"),
    ("fused_encode", 16, 32_768, 8, 1, "with_y"),
    ("fused_encode", 1, 32_768, 8, 1, "sign_rows"),
    ("quantize_codes", 1, 32_768, 8, 1, "down"),
    ("quantize_codes", 16, 32_768, 4, 2, "packed"),
    ("quantize_codes", 1, cs.BENCH_D, 8, 1, "down"),
    ("quantize_codes", cs.BENCH_M, cs.BENCH_D, 8, 1, "bench"),
    ("snap_codes", 16, 32_768, 8, 1, "up"),
    ("snap_codes", 16, 32_768, 8, 1, "down"),
    ("snap_codes", 16, 32_768, 4, 2, "up"),
    ("snap_codes", cs.BENCH_M, cs.BENCH_D, 8, 1, "up"),
    ("snap_codes", cs.BENCH_M, cs.BENCH_D, 8, 1, "down"),
    ("fused_decode", 1, 32_768, 8, 1, "sign_rows"),
    ("fused_decode", 16, 32_768, 8, 1, "sign_rows"),
)
# (n, r, c, dtype): the ops path's 25,450 and 10^7 coordinates, 2^25 in
# fp32 and bf16, and the largest block
HADAMARD_SHAPES = (
    (2, 128, 128, cs.FP32), (611, 128, 128, cs.FP32),
    (2048, 128, 128, cs.FP32), (2048, 128, 128, cs.BF16),
    (1024, 256, 128, cs.FP32),
)
CLUSTER_SWEEP = (2048, 128, 128)
# (s, d_pad) of the fused snaps: olmo-1b's round and the paper MLP's
FUSED_SHAPES = ((2, 1_176_764_416), (16, 32_768))
# the quantize's path shapes and a bench row, also timed at each count of
# outputs a thread its kernel takes
QUANTIZE_SWEEP = ((1, 32_768), (16, 32_768), (1, cs.BENCH_D))
# a part of the kernel's symbol, in older commits (rotate_kernel,
# quantize_kernel, hadamard_kernel<T>) and in this one
# (rotate_cluster_kernel<C>, quantize_vec_kernel,
# hadamard_cluster_kernel<C, T>)
SYMBOLS = {"fused_rotate": "rotate_", "fused_encode": "encode_",
           "quantize_codes": "quantize_", "snap_codes": "snap_",
           "fused_decode": "decode_", "hadamard_blocks": "hadamard_"}


def exchange_run(kx, dev, gen, kernel, m, d_pad, bits, pack, how):
    """(run, the plain version's output, bytes moved, forced runs) of one
    shape; the forced runs, as (launch, run), are the quantize's at each
    other count of outputs a thread."""
    from repro_torch.compression.rotation import signs
    x = torch.randn((m, d_pad), generator=gen, device=dev)
    sg = signs(gen, d_pad)
    u = torch.rand((m, d_pad), generator=gen, device=dev)
    y0 = kx.rotate_plain(x, sg)
    gam = (y0.abs().amax(dim=1) / (1 << bits) / 2).contiguous()
    kw = dict(bits=bits, pack=pack)
    if kernel == "fused_rotate":
        inverse = how == "inverse"

        def run():
            return kx.fused_rotate(x, sg, inverse=inverse)
        return run, kx.rotate_plain(x, sg, inverse=inverse), \
            cs.nbytes(x, sg, x), []
    if kernel == "fused_encode":
        s = sg if how == "with_y" else sg.expand(m, d_pad).contiguous()
        want_y = how == "with_y"

        def run():
            return kx.fused_encode(x, s, u, gam, want_rotated=want_y, **kw)
        want = kx.encode_plain(x, s, u, gam, want_rotated=want_y, **kw)
        codes = want[1] if want_y else want
        return run, want, cs.nbytes(x, s, u, gam, codes) + (
            cs.nbytes(x) if want_y else 0), []
    if kernel == "quantize_codes":
        codes = kx.fused_encode(x, sg, u, gam, **kw)
        assert torch.equal(kx.quantize_codes(y0, u, gam, **kw), codes)

        def run():
            return kx.quantize_codes(y0, u, gam, **kw)
        forced = []
        if (m, d_pad) in QUANTIZE_SWEEP and hasattr(kx, "quantize_geometry"):
            picked = kx.quantize_geometry(m, d_pad, pack=pack)["per_thread"]
            forced = [({"per_thread": v, "forced": True},
                       lambda v=v: kx._launch_quantize(
                           y0, u, gam, bits, kx.DEFAULT_BLOCK, pack, None, v))
                      for v in (2, 8) if v != picked]
        return run, kx.quantize_plain(y0, u, gam, **kw), \
            cs.nbytes(y0, u, gam, codes), forced
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
    if kernel == "fused_decode":
        s = sg.expand(m, d_pad).contiguous()
        codes = kx.fused_encode(x, s, u, gam, **kw)
        ref = x + 0.1 * gam[:, None] * torch.randn(
            (m, d_pad), generator=gen, device=dev)

        def run():
            return kx.fused_decode(codes, ref, s, gam, **kw)
        return run, kx.decode_plain(codes, ref, s, gam, **kw), \
            cs.nbytes(codes, ref, s, gam, x), []
    w = y + 0.25 * gam[:, None] * torch.randn((m, d_pad), generator=gen,
                                              device=dev)
    args = ((codes, w[:1].contiguous(), gam) if how == "up" else
            (codes[:1].contiguous(), w, gam[:1].contiguous()))

    def run():
        return kx.snap_codes(*args, **kw)
    return run, kx.snap_plain(*args, **kw), cs.nbytes(*args, y), []


def fused_rows(kx, dev, gen, peak_bw, emit):
    """``uplink`` and ``average`` at FUSED_SHAPES (b = 8 up and down):
    device ms of each kernel a call, the wrapper's ms, the byte bound, the
    passes they replace timed alike, and the check against the plain
    versions (averages bit for bit, rel_err and hint_srv within 1e-5)."""
    for s, d_pad in FUSED_SHAPES:
        srv = torch.randn((1, d_pad), generator=gen, device=dev)
        y = srv + 0.1 * torch.randn((s, d_pad), generator=gen, device=dev)
        g_up = ((y - srv).abs().amax(dim=1) / 64).contiguous()
        g_dn = ((y - srv).abs().amax() / 64).reshape(1)
        u = torch.rand((s, d_pad), generator=gen, device=dev)
        c_up = kx.quantize_codes(y, u, g_up)
        c_dn = kx.quantize_codes(srv, u[:1], g_dn)
        del u
        got = kx.uplink(c_up, srv, y, g_up)
        want = kx.uplink_plain(c_up, srv, y, g_up)
        ok = bool(torch.equal(got[0], want[0])) and all(
            abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
            for a, b in zip(got[1:], want[1:]))
        del got, want

        def unfused_up():
            qy = kx.snap_codes(c_up, srv, g_up)
            n = torch.linalg.vector_norm
            rel = torch.mean(n(qy - y, dim=1) / (n(y, dim=1) + 1e-9))
            hint = torch.max(n(qy - srv, dim=1)) + 1e-8
            return (srv[0] + torch.sum(qy, 0)) / (s + 1), rel, hint

        nb = cs.nbytes(c_up, srv, y, srv)
        emit({"kernel": "uplink", "shape": [s, d_pad], "bits": 8,
              "pack": 1, "launch": kx.uplink_geometry(s, d_pad),
              "equal": ok,
              "device_ms": cs.kernel_device_ms(
                  lambda: kx.uplink(c_up, srv, y, g_up),
                  "snap_vec_kernel_up_average"),
              "finish_device_ms": cs.kernel_device_ms(
                  lambda: kx.uplink(c_up, srv, y, g_up),
                  "snap_vec_kernel_up_finish"),
              "ms": cs.time_ms(lambda: kx.uplink(c_up, srv, y, g_up)),
              "unfused_ms": cs.time_ms(unfused_up),
              "bound_ms": nb / peak_bw * 1e3})
        assert ok
        work = y.clone()
        got = kx.average(c_dn, work, g_dn)
        ok = bool(torch.equal(got, kx.average_plain(c_dn, y.clone(),
                                                    g_dn)))
        del got

        def unfused_avg():
            qx = kx.snap_codes(c_dn, work, g_dn)
            return qx.div_(s + 1).add_(work.mul_(s).div_(s + 1))

        # each call averages ``work`` again: the values move, the time not
        emit({"kernel": "average", "shape": [s, d_pad], "bits": 8,
              "pack": 1, "launch": kx.average_geometry(s, d_pad),
              "equal": ok,
              "device_ms": cs.kernel_device_ms(
                  lambda: kx.average(c_dn, work, g_dn),
                  "snap_vec_kernel_down_average"),
              "ms": cs.time_ms(lambda: kx.average(c_dn, work, g_dn)),
              "unfused_ms": cs.time_ms(unfused_avg),
              "bound_ms": cs.nbytes(c_dn, y, y) / peak_bw * 1e3})
        assert ok
        del srv, y, c_up, c_dn, work


def equal(got, want):
    if isinstance(want, tuple):
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def timed_row(run, want, bytes_moved, peak_bw, symbol, **fields):
    row = {**fields, "equal": equal(run(), want),
           "device_ms": cs.kernel_device_ms(run, symbol),
           "ms": cs.time_ms(run),
           "bound_ms": bytes_moved / peak_bw * 1e3}
    assert row["equal"] and row["device_ms"] is not None, row
    return row


def run_shapes(kx, hd, dev, smi, peak_bw, src):
    """Time and check every row of SHAPES and HADAMARD_SHAPES on ``dev``,
    one JSON line each."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)

    def emit(row):
        print(json.dumps({"phase": "kernel_shape", "src": str(src),
                          "nvidia_smi": smi, **row}), flush=True)
        torch.cuda.empty_cache()

    for kernel, m, d_pad, bits, pack, how in SHAPES:
        run, want, nb, forced = exchange_run(kx, dev, gen, kernel, m, d_pad,
                                             bits, pack, how)
        row = dict(kernel=kernel, shape=[m, d_pad], bits=bits, pack=pack,
                   use=how)
        if kernel == "quantize_codes" and hasattr(kx, "quantize_geometry"):
            row["launch"] = kx.quantize_geometry(m, d_pad, pack=pack)
        emit(timed_row(run, want, nb, peak_bw, SYMBOLS[kernel], **row))
        for launch, f in forced:
            emit(timed_row(f, want, nb, peak_bw, SYMBOLS[kernel],
                           **{**row, "launch": launch}))
        del run, want, forced
    if hasattr(kx, "uplink"):
        fused_rows(kx, dev, gen, peak_bw, emit)
    # an older hadamard module picks no cluster
    picks = getattr(hd, "launch_geometry", lambda n, r, c: None)
    for n, r, c, dtype in HADAMARD_SHAPES:
        x = torch.randn((n, r, c), generator=gen, device=dev).to(dtype)
        want = hd.hadamard_plain(x)
        geo = picks(n, r, c)
        runs = [(geo, lambda x=x: hd.hadamard_blocks(x))]
        if (n, r, c) == CLUSTER_SWEEP and dtype == cs.FP32 and geo:
            runs += [({"cluster": cl, "forced": True},
                      lambda cl=cl, x=x: hd._launch(x, cl))
                     for cl in (2, 4, 8) if cl != geo["cluster"]]
        for launch, run in runs:
            emit(timed_row(run, want, cs.nbytes(x, want), peak_bw,
                           SYMBOLS["hadamard_blocks"],
                           kernel="hadamard_blocks", shape=[n, r, c],
                           dtype=str(dtype).split(".")[1], launch=launch))
        del x, want, runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_shapes: no CUDA device", file=sys.stderr)
        return 1
    src = Path(sys.argv[1] if len(sys.argv) > 1 else cs.ROOT / "src")
    src = src.resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import exchange as kx
    from repro_torch.kernels import hadamard as hd
    for module in (kx, hd):
        assert Path(module.__file__).resolve().is_relative_to(src), module
    smi = cs.smi_line()
    run_shapes(kx, hd, torch.device("cuda", 0), smi,
               cs.peak_bytes_per_s(torch.cuda.get_device_name(0)), src)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
