"""The butterfly decomposition of the cluster kernels behind ``fused_encode``
and ``fused_decode`` (``csrc/exchange.cu``), emulated on the CPU.

The kernels split a Hadamard block of b coordinates across a cluster of C
CTAs, n = b / C contiguous coordinates a CTA and 8 a thread: stages h = 1,
2, 4 in each thread's registers, h = 8 .. 128 across the lanes of a warp,
h = 256 .. n/2 through shared memory three at a time (a sliding window of
three index bits), and h = n .. b/2 across the cluster, each CTA gathering
its share of offsets from every peer. The emulation below moves the values
as the kernel does (registers as a (C, threads, 8) array, a shuffle as a
gather at lane ^ 2^s) and runs every stage with the pairs of the plain
version's ``_fwht``: so it must be ``torch.equal`` to ``_fwht``, and its
codes equal to the plain version's bit for bit. Against the JAX reference,
which rotates by two matmuls (another rounding), the codes are held to the
tolerance of ``test_torch_exchange.py``: ±1 mod L on at most 1e-4 of the
coordinates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import circular_gap, gauss, npy, signs_np, tt, uniform
from repro.kernels import exchange as ref_kx
from repro_torch.kernels import exchange as kx

VALS, WARP = 8, 32            # coordinates a thread holds; lanes a warp


def _reg_stage(v, p):
    """Butterfly on bit p of the last axis (8 registers): pairs (e, e + 2^p),
    a + c at the lower index, a - c at the upper."""
    shape = v.shape
    w = v.reshape(*shape[:-1], VALS >> (p + 1), 2, 1 << p)
    a, c = w[..., 0, :], w[..., 1, :]
    return torch.stack((a + c, a - c), dim=-2).reshape(shape)


def emulate_fwht(x, cluster):
    """Unscaled H_b of each row of x (rows, b) as the cluster kernel runs
    it with ``cluster`` CTAs a block."""
    rows, b = x.shape
    n = b // cluster
    k = n.bit_length() - 1
    threads = max(WARP, n // VALS)
    assert cluster == 1 or n >= VALS * WARP, "a cluster needs full warps"
    # registers: CTA rank, thread t, coordinates 8t .. 8t+7 of the chunk
    regs = torch.zeros((rows, cluster, threads * VALS))
    regs[:, :, :n] = x.reshape(rows, cluster, n)
    v = regs.reshape(rows, cluster, threads, VALS)
    for p in range(3):                                  # h = 1, 2, 4
        if 1 << p < n:
            v = _reg_stage(v, p)
    t = torch.arange(threads)
    for s in range(5):                                  # h = 8 .. 128
        if VALS << s >= n:
            break
        other = v[:, :, t ^ (1 << s)]                   # __shfl_xor_sync
        upper = ((t % WARP >> s) & 1).bool()[:, None]
        v = torch.where(upper, other - v, v + other)
    sm = v.reshape(rows, cluster, threads * VALS)[:, :, :n].clone()
    lo = 8
    while lo < k:                                       # h = 256 .. n/2
        w = min(lo, k - 3)
        base = (t & ((1 << w) - 1)) | ((t >> w) << (w + 3))
        idx = (base[:, None] + (torch.arange(VALS) << w)).reshape(-1)
        x8 = sm[:, :, idx].reshape(rows, cluster, threads, VALS)
        for p in range(lo - w, 3):
            x8 = _reg_stage(x8, p)
        sm[:, :, idx] = x8.reshape(rows, cluster, -1)
        lo += 3
    if cluster > 1:                                     # h = n .. b/2
        per, share = VALS // cluster, n // cluster
        for rank in range(cluster):
            off = (rank * share + t[:, None]
                   + threads * torch.arange(per)).reshape(-1)
            # register e = j * C + p holds peer p's value at offset j
            g = sm[:, :, off].reshape(rows, cluster, threads, per)
            g = g.permute(0, 2, 3, 1).reshape(rows, threads, VALS)
            for p in range(cluster.bit_length() - 1):
                g = _reg_stage(g, p)
            g = g.reshape(rows, threads, per, cluster).permute(0, 3, 1, 2)
            sm[:, :, off] = g.reshape(rows, cluster, -1)
    return sm.reshape(rows, b)


def emulate_encode(x2, signs, u2, gammas, *, bits, pack, cluster=None):
    """fused_encode as the cluster kernel computes it: (y, codes), packed
    codes assembled chunk by chunk (each CTA packs its own rows)."""
    m, d_pad = x2.shape
    b, _, r, c, nb = kx.block_geometry(d_pad)
    cluster = cluster or kx.cluster_size(b, r, pack)
    xs = (x2 * signs).reshape(-1, b)
    y = (emulate_fwht(xs, cluster) * kx._scale(b)).reshape(m, d_pad)
    codes = kx._quantize(y, u2, gammas, bits, None)
    if pack == 1:
        return y, codes
    n = b // cluster
    assert (n // c) % pack == 0, "a packed byte spans two CTAs"
    chunks = codes.reshape(m, nb, cluster, n // c // pack, pack, c)
    shifts = (torch.arange(pack, dtype=torch.int32) * bits).reshape(
        1, 1, 1, 1, pack, 1)
    packed = (chunks << shifts).sum(dim=4).to(torch.uint8)
    return y, packed.reshape(m, d_pad // pack)


def emulate_decode(codes2, ref2, signs, gammas, *, bits, pack):
    """fused_decode as the cluster kernel computes it (one sign row)."""
    m, d_pad = max(codes2.shape[0], ref2.shape[0]), ref2.shape[1]
    b, _, r, _, _ = kx.block_geometry(d_pad)
    cluster = kx.cluster_size(b, r, pack)
    scale = kx._scale(b)

    def fwht(z):
        return emulate_fwht(z.reshape(-1, b), cluster).reshape(z.shape)
    w = fwht(ref2 * signs) * scale
    q = kx.snap_plain(codes2, w.expand(m, d_pad), gammas, bits=bits,
                      pack=pack)
    return fwht(q) * scale * signs


CASES = [(b, cl) for b in (1 << e for e in range(5, 15))
         for cl in (1, 2, 4, 8) if cl == 1 or b // cl >= VALS * WARP]


@pytest.mark.parametrize("b,cluster", CASES)
def test_emulated_butterfly_is_the_plain_transform(b, cluster):
    x = tt(gauss(b + cluster, (3, b)))
    assert torch.equal(emulate_fwht(x, cluster), kx._fwht(x))


def test_cluster_sizes_the_wrapper_picks():
    geo = {d: kx.launch_geometry(16, d) for d in (1024, 2048, 4096, 8192,
                                                  32_768, 1 << 20)}
    assert {d: g["cluster"] for d, g in geo.items()} == {
        1024: 1, 2048: 1, 4096: 2, 8192: 4, 32_768: 8, 1 << 20: 8}
    assert geo[32_768]["ctas"] == 256 and geo[32_768]["threads"] == 256
    assert kx.launch_geometry(1, 32_768)["ctas"] == 16
    # 1-bit codes pack 8 rows a byte: the chunk keeps whole groups
    for d in (4096, 8192, 32_768):
        b, _, r, c, _ = kx.block_geometry(d)
        cl = kx.cluster_size(b, r, 8)
        assert (b // cl // c) % 8 == 0


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2)])
@pytest.mark.parametrize("d_pad", [4096, 32_768])
def test_emulated_encode_matches_plain_and_reference(d_pad, bits, pack):
    m = 2
    x = gauss(40, (m, d_pad))
    sg, u = signs_np(41, d_pad), uniform(42, (m, d_pad))
    y0 = npy(kx.rotate_plain(tt(x), tt(sg)))
    g = (np.abs(y0).max(axis=1) / (1 << bits) / 2).astype(np.float32)
    y, codes = emulate_encode(tt(x), tt(sg), tt(u), tt(g), bits=bits,
                              pack=pack)
    y_p, codes_p = kx.encode_plain(tt(x), tt(sg), tt(u), tt(g), bits=bits,
                                   pack=pack, want_rotated=True)
    assert torch.equal(y, y_p) and torch.equal(codes, codes_p)
    b, _, _, c, _ = kx.block_geometry(d_pad)
    for cl in (1, 2, 4, 8):     # every cluster size gives the same codes
        if (cl == 1 or b // cl >= VALS * WARP) and (b // cl // c) % pack == 0:
            assert torch.equal(emulate_encode(tt(x), tt(sg), tt(u), tt(g),
                                              bits=bits, pack=pack,
                                              cluster=cl)[1], codes)
    c_ref = ref_kx.fused_encode(jnp.asarray(x), jnp.asarray(sg),
                                jnp.asarray(u), jnp.asarray(g), bits=bits,
                                pack=pack)
    unpack = ((lambda a: npy(kx.unpack_codes(tt(npy(a)), bits=bits)))
              if pack > 1 else npy)
    gap = circular_gap(unpack(codes).astype(np.int64),
                       unpack(c_ref).astype(np.int64), 1 << bits)
    assert gap.max() <= 1 and (gap > 0).mean() <= 1e-4


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (1, 8)])
def test_emulated_decode_is_the_plain_decode(bits, pack):
    m, d_pad = 2, 8192
    x = gauss(50, (m, d_pad))
    sg, u = signs_np(51, d_pad), uniform(52, (m, d_pad))
    y0 = npy(kx.rotate_plain(tt(x), tt(sg)))
    g = (np.abs(y0).max(axis=1) / (1 << bits) / 2).astype(np.float32)
    codes = kx.encode_plain(tt(x), tt(sg), tt(u), tt(g), bits=bits,
                            pack=pack)
    ref = tt(x[:1] + gauss(53, (1, d_pad), 0.01))
    out = emulate_decode(codes, ref, tt(sg), tt(g), bits=bits, pack=pack)
    assert torch.equal(out, kx.decode_plain(codes, ref, tt(sg), tt(g),
                                            bits=bits, pack=pack))
