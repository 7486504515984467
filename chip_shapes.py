#!/usr/bin/env python3
"""Device time a launch of the exchange's ``fused_rotate`` and
``snap_codes`` at each shape the QuAFL round launches them with, and at the
bench shape, from torch.profiler:

    python3 chip_shapes.py [SRC]

SRC is the directory that holds the ``repro_torch`` package to time (this
checkout's ``src/`` by default). Pointed at an older commit's unpacked
``src/``, it times that commit's kernels, so two versions compare on one
card in one call. Each launch is also held ``torch.equal`` to its plain
version. Prints one JSON line per shape, then the card's name and power
limit; exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs           # puts this checkout's src/ on sys.path

# (kernel, messages, d_pad, bits, pack, what the round does with it); the
# snap's "down" rows are one code row against m references
SHAPES = (
    ("fused_rotate", 1, 32_768, 8, 1, "forward"),
    ("fused_rotate", 1, 32_768, 8, 1, "inverse"),
    ("fused_rotate", 16, 32_768, 8, 1, "inverse"),
    ("fused_rotate", cs.BENCH_M, cs.BENCH_D, 8, 1, "inverse"),
    ("snap_codes", 16, 32_768, 8, 1, "up"),
    ("snap_codes", 16, 32_768, 8, 1, "down"),
    ("snap_codes", 16, 32_768, 4, 2, "up"),
    ("snap_codes", cs.BENCH_M, cs.BENCH_D, 8, 1, "up"),
    ("snap_codes", cs.BENCH_M, cs.BENCH_D, 8, 1, "down"),
)
# a part of the kernel's symbol, in older commits (rotate_kernel,
# snap_kernel) and in this one (rotate_cluster_kernel<C>, snap_vec_kernel)
SYMBOLS = {"fused_rotate": "rotate_", "snap_codes": "snap_"}


def shape_row(kx, dev, gen, kernel, m, d_pad, bits, pack, how):
    from repro_torch.compression.rotation import signs
    x = torch.randn((m, d_pad), generator=gen, device=dev)
    sg = signs(gen, d_pad)
    if kernel == "fused_rotate":
        inverse = how == "inverse"

        def run():
            return kx.fused_rotate(x, sg, inverse=inverse)
        want = kx.rotate_plain(x, sg, inverse=inverse)
    else:
        u = torch.rand((m, d_pad), generator=gen, device=dev)
        y0 = kx.rotate_plain(x, sg)
        gam = (y0.abs().amax(dim=1) / (1 << bits) / 2).contiguous()
        y, codes = kx.fused_encode(x, sg, u, gam, bits=bits, pack=pack,
                                   want_rotated=True)
        w = y + 0.25 * gam[:, None] * torch.randn((m, d_pad), generator=gen,
                                                  device=dev)
        args = ((codes, w[:1].contiguous(), gam) if how == "up" else
                (codes[:1].contiguous(), w, gam[:1].contiguous()))

        def run():
            return kx.snap_codes(*args, bits=bits, pack=pack)
        want = kx.snap_plain(*args, bits=bits, pack=pack)
    row = {"kernel": kernel, "shape": [m, d_pad], "bits": bits,
           "pack": pack, "use": how, "equal": torch.equal(run(), want),
           "device_ms": cs.kernel_device_ms(run, SYMBOLS[kernel])}
    assert row["equal"] and row["device_ms"] is not None, row
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_shapes: no CUDA device", file=sys.stderr)
        return 1
    src = Path(sys.argv[1] if len(sys.argv) > 1 else cs.ROOT / "src")
    src = src.resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import exchange as kx
    assert Path(kx.__file__).resolve().is_relative_to(src), kx.__file__
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    smi = cs.smi_line()
    for shape in SHAPES:
        row = shape_row(kx, dev, gen, *shape)
        print(json.dumps({"phase": "kernel_shape", "src": str(src),
                          "nvidia_smi": smi, **row}), flush=True)
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
