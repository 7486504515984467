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

``fused_rotate`` runs the same butterfly alone (``rotate_cluster_kernel``):
its emulation is held ``torch.equal`` to ``rotate_plain`` and, against the
reference's matmul rotation, within 1e-5·max|y| (the rotation tolerance of
``test_torch_kernel_ops.py``). ``snap_codes`` (``snap_vec_kernel``) takes 8
contiguous coordinates of one row a thread, its packed codes in one 8-byte
load where c is a multiple of 8 and byte by byte where it is not; the
emulation of that mapping is held ``torch.equal`` to ``snap_plain`` and
exactly equal to the reference's snap, as ``test_torch_exchange.py`` holds
the plain version. ``quantize_codes`` (``quantize_vec_kernel<V>``) takes V
contiguous outputs of one row a thread (8, or 2 on a small launch):
int32 codes of V coordinates, or V packed bytes OR-ed from ``pack`` rows of
V floats and stored as one V-byte word where c is a multiple of V, byte by
byte where it is not; its emulation at every V is held ``torch.equal`` to
``quantize_plain`` and exactly equal to the reference's
``quantize_codes``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import circular_gap, gauss, npy, signs_np, tt, uniform
from repro.kernels import exchange as ref_kx
from repro_torch.compression.rotation import DEFAULT_BLOCK
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
    # the rotation (pack 1): 16 CTAs of 256 threads for one message of two
    # 16,384-blocks, 256 for 16; chunks of 4,096 at b = 32,768
    rot = kx.launch_geometry(1, 32_768, pack=1)
    assert (rot["cluster"], rot["ctas"], rot["threads"]) == (8, 16, 256)
    assert kx.launch_geometry(16, 32_768, pack=1)["ctas"] == 256
    big = kx.launch_geometry(3, 65_536, block=32_768, pack=1)
    assert (big["cluster"], big["chunk"], big["threads"]) == (8, 4096, 512)
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


def emulate_rotate(x2, signs, *, inverse=False, cluster=None,
                   block=DEFAULT_BLOCK):
    """fused_rotate as the cluster kernel computes it: the signs before the
    butterfly (forward) or after the scale (inverse)."""
    m, d_pad = x2.shape
    b, _, r, _, _ = kx.block_geometry(d_pad, block)
    cluster = cluster or kx.cluster_size(b, r, 1)
    x = x2 if inverse else x2 * signs
    y = emulate_fwht(x.reshape(-1, b), cluster).reshape(m, d_pad)
    y = y * kx._scale(b)
    return y * signs if inverse else y


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("b,cluster", CASES)
def test_emulated_rotate_is_the_plain_rotation(b, cluster, inverse):
    d_pad = 2 * b
    x = tt(gauss(b + 7, (3, d_pad)))
    sg = tt(signs_np(b + 8, d_pad))
    y = emulate_rotate(x, sg, inverse=inverse, cluster=cluster, block=b)
    assert torch.equal(y, kx.rotate_plain(x, sg, block=b, inverse=inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("d_pad", [4096, 32_768])
def test_emulated_rotate_matches_reference(d_pad, m, inverse):
    x, sg = gauss(60 + m, (m, d_pad)), signs_np(61, d_pad)
    y = npy(emulate_rotate(tt(x), tt(sg), inverse=inverse))
    y_ref = npy(ref_kx.fused_rotate(jnp.asarray(x), jnp.asarray(sg),
                                    inverse=inverse))
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


def _word(cb, base):
    """The 32-bit little-endian words at byte offsets ``base`` and base + 4
    of each row of cb (an aligned 8-byte load as two halves)."""
    b32 = cb.to(torch.int64)
    return [sum(b32[:, base + 4 * h + q] << (8 * q) for q in range(4))
            for h in range(2)]


def emulate_snap(codes2, wrot2, gammas, *, bits, pack, block=DEFAULT_BLOCK,
                 levels2=None):
    """snap_codes as snap_vec_kernel computes it: thread g of a row takes
    coordinates 8g .. 8g + 7; packed codes from one 8-byte word at (row /
    pack)·c + col shifted by (row % pack)·bits where c is a multiple of 8,
    else byte by byte at each coordinate's own (row, col)."""
    mc, mw = codes2.shape[0], wrot2.shape[0]
    m, d_pad = max(mc, mw), wrot2.shape[1]
    b, _, _, c, _ = kx.block_geometry(d_pad, block)
    e0 = torch.arange(0, d_pad, VALS)                   # a thread's first
    e = torch.arange(VALS)
    nv = torch.clamp(d_pad - e0, max=VALS)
    at = e0[:, None] + torch.minimum(e, nv[:, None] - 1)   # clamped
    codes = codes2.expand(m, -1) if mc == 1 else codes2
    w = (wrot2.expand(m, -1) if mw == 1 else wrot2)[:, at]
    mask = (1 << bits) - 1
    if pack == 1:
        code = codes[:, at]
    elif c % VALS == 0:                                 # one 8-byte load
        j = e0 // b
        row = (e0 - j * b) // c
        col = e0 - j * b - row * c
        base = j * (b // pack) + (row // pack) * c + col
        assert bool((base % 8 == 0).all()), "the word is aligned"
        lo, hi = _word(codes, base)
        shift = (row % pack) * bits
        code = torch.stack([((lo if q < 4 else hi) >> (8 * (q % 4) + shift))
                            & mask for q in range(VALS)], dim=-1)
    else:                                               # byte by byte
        j = at // b
        row = (at - j * b) // c
        col = at - j * b - row * c
        byte = codes[:, j * (b // pack) + (row // pack) * c + col]
        code = (byte.to(torch.int64) >> ((row % pack) * bits)) & mask
    code = code.to(torch.float32)
    g = gammas.reshape(-1, 1, 1)
    lv = (float(1 << bits) if levels2 is None else levels2.reshape(-1, 1, 1))
    v = (code + lv * torch.round((w / g - code) / lv)) * g
    out = torch.empty((m, d_pad))
    keep = e < nv[:, None]
    out[:, at[keep]] = v[:, keep]
    return out


def _snap_inputs(seed, mc, mw, d_pad, bits, pack, block, levels):
    """Codes covering the ring, references near them, a γ row of max(mc,
    mw) values, and a levels row when asked."""
    m = max(mc, mw)
    rng = np.random.default_rng(seed)
    lv = (np.maximum(1, (1 << bits) >> np.arange(m) % 3).astype(np.float32)
          if levels else None)
    top = (1 << bits) if lv is None else lv[:mc, None].astype(np.int64)
    codes = (rng.integers(0, 1 << 16, (mc, d_pad)) % top).astype(np.int32)
    packed = (npy(kx.pack_codes(tt(codes), bits=bits, block=block))
              if pack > 1 else codes)
    w = gauss(seed + 1, (mw, d_pad), 0.1)
    g = (0.01 * (1 + np.arange(m))).astype(np.float32)
    return packed, w, g, lv


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("mc,mw", [(3, 1), (1, 3)])
@pytest.mark.parametrize("d_pad,block", [(128, 32), (32_768, 16_384)])
@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (1, 8)])
def test_emulated_snap_is_the_plain_snap(bits, pack, d_pad, block, mc, mw,
                                         levels):
    packed, w, g, lv = _snap_inputs(70, mc, mw, d_pad, bits, pack, block,
                                    levels)
    kw = dict(bits=bits, pack=pack, block=block,
              levels2=None if lv is None else tt(lv))
    out = emulate_snap(tt(packed), tt(w), tt(g), **kw)
    assert out.shape == (max(mc, mw), d_pad)
    assert torch.equal(out, kx.snap_plain(tt(packed), tt(w), tt(g), **kw))


@pytest.mark.parametrize("mc,mw", [(3, 1), (1, 3)])
@pytest.mark.parametrize("d_pad,block", [(128, 32), (32_768, 16_384)])
@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (1, 8)])
def test_emulated_snap_matches_reference(bits, pack, d_pad, block, mc, mw):
    packed, w, g, _ = _snap_inputs(80, mc, mw, d_pad, bits, pack, block,
                                   False)
    out = emulate_snap(tt(packed), tt(w), tt(g), bits=bits, pack=pack,
                       block=block)
    ref_codes = packed if pack > 1 else packed.astype(np.uint32)
    q_ref = ref_kx.snap_codes(jnp.asarray(ref_codes), jnp.asarray(w),
                              jnp.asarray(g), bits=bits, pack=pack,
                              block=block)
    np.testing.assert_array_equal(npy(out), npy(q_ref))


def test_snap_grid_the_wrapper_reports():
    """256 threads of 8 coordinates a CTA: 16 CTAs a 32,768-row."""
    assert kx.snap_geometry(16, 32_768) == {"ctas": 256, "threads": 256}
    assert kx.snap_geometry(1, 96) == {"ctas": 1, "threads": 256}


def emulate_quantize(y2, u2, gammas, *, bits, pack, block=DEFAULT_BLOCK,
                     levels2=None, per_thread=None):
    """quantize_codes as quantize_vec_kernel<V> computes it, V outputs a
    thread (the wrapper's ``quantize_geometry`` unless given): thread g of
    a row takes outputs Vg .. Vg + V − 1 of its d_pad / pack; unpacked,
    the codes of coordinates Vg .. Vg + V − 1 (loads clamped into the
    row); packed with c a multiple of V, bytes (p, k .. k + V − 1) of block
    j from V floats of each of rows p·pack .. p·pack + pack − 1, assembled
    into little-endian 32-bit words; else byte by byte at each output's
    own (j, p, k)."""
    m, d_pad = y2.shape
    b, _, _, c, _ = kx.block_geometry(d_pad, block)
    v = per_thread or kx.quantize_geometry(m, d_pad,
                                           pack=pack)["per_thread"]
    per, nbytes = d_pad // pack, b // pack
    o0 = torch.arange(0, per, v)                        # a thread's first
    e = torch.arange(v)
    nv = torch.clamp(per - o0, max=v)
    keep = e < nv[:, None]

    def codes_at(at):                                   # (m, threads, V)
        q = kx._quantize(y2[:, at.reshape(-1)], u2[:, at.reshape(-1)],
                         gammas, bits, levels2)
        return q.reshape(m, *at.shape).to(torch.int64)

    if pack == 1:
        at = o0[:, None] + torch.minimum(e, nv[:, None] - 1)   # clamped
        out = torch.empty((m, per), dtype=torch.int32)
        out[:, at[keep]] = codes_at(at)[:, keep].to(torch.int32)
        return out
    if c % v == 0:                                      # one V-byte store
        assert bool((nv == v).all()) and per % v == 0
        j = o0 // nbytes
        p = (o0 - j * nbytes) // c
        e0 = j * b + p * pack * c + (o0 - j * nbytes - p * c)
        acc = sum(codes_at(e0[:, None] + tt * c + e) << (tt * bits)
                  for tt in range(pack))
        words = [sum((acc[..., q] & 0xff) << (8 * (q % 4))
                     for q in range(h, min(h + 4, v)))
                 for h in range(0, v, 4)]
        byte = torch.stack([(words[q // 4] >> (8 * (q % 4))) & 0xff
                            for q in range(v)], dim=-1)
        return byte.reshape(m, per).to(torch.uint8)     # every thread's V
    o = o0[:, None] + e                                 # byte by byte
    j = o // nbytes
    p = (o - j * nbytes) // c
    at = j * b + p * pack * c + (o - j * nbytes - p * c)
    at = torch.where(keep, at, 0)                       # never read
    acc = sum(codes_at(at + tt * c) << (tt * bits) for tt in range(pack))
    out = torch.empty((m, per), dtype=torch.uint8)
    out[:, o[keep]] = (acc[:, keep] & 0xff).to(torch.uint8)
    return out


def _quantize_inputs(seed, m, d_pad, bits, block, gam_rows, levels):
    """Rotated-like y (a few wraps of the ring at γ), U(0,1) noise, a γ row
    of m values or one, and a levels row of m values, one, or none."""
    y = gauss(seed, (m, d_pad))
    u = uniform(seed + 1, (m, d_pad))
    top = np.abs(y).max(axis=1) / (1 << bits) / 2
    g = (top if gam_rows else top[:1]).astype(np.float32)
    lv = None
    if levels == "rows":
        lv = np.maximum(1, (1 << bits) >> np.arange(m) % 3).astype(np.float32)
    elif levels == "one":
        lv = np.array([max(1, (1 << bits) >> 1)], np.float32)
    return y, u, g, lv


# (d_pad, block): c < 8 (b = 32, (8, 4)) with rows whose packed length is
# not a multiple of 8 (96 / pack), a tail CTA (3,072 / pack outputs, not a
# multiple of 2,048) at b = 1,024 (32 x 32), and the paths' 32,768
QUANTIZE_GEOMETRIES = [(128, 32), (96, 32), (3072, 1024), (32_768, 16_384)]
QUANTIZE_ROWS = [(3, True, None), (3, False, "one"), (4, True, "rows"),
                 (1, True, None)]


@pytest.mark.parametrize("m,gam_rows,levels", QUANTIZE_ROWS)
@pytest.mark.parametrize("d_pad,block", QUANTIZE_GEOMETRIES)
@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_emulated_quantize_is_the_plain_quantize(bits, pack, d_pad, block,
                                                 m, gam_rows, levels):
    y, u, g, lv = _quantize_inputs(90 + m, m, d_pad, bits, block, gam_rows,
                                   levels)
    kw = dict(bits=bits, pack=pack, block=block,
              levels2=None if lv is None else tt(lv))
    want = kx.quantize_plain(tt(y), tt(u), tt(g), **kw)
    for v in (None, 2, 8):       # the wrapper's pick, then each kernel
        out = emulate_quantize(tt(y), tt(u), tt(g), per_thread=v, **kw)
        assert out.shape == (m, d_pad // pack)
        assert torch.equal(out, want)


@pytest.mark.parametrize("m,gam_rows,levels", QUANTIZE_ROWS[:3])
@pytest.mark.parametrize("d_pad,block", [(96, 32), (3072, 1024)])
@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (1, 8)])
def test_emulated_quantize_matches_reference(bits, pack, d_pad, block, m,
                                             gam_rows, levels):
    y, u, g, lv = _quantize_inputs(100 + m, m, d_pad, bits, block, gam_rows,
                                   levels)
    ref = ref_kx.quantize_codes(jnp.asarray(y), jnp.asarray(u),
                                jnp.asarray(g), bits=bits, pack=pack,
                                block=block,
                                levels2=None if lv is None
                                else jnp.asarray(lv))
    for v in (2, 8):
        out = emulate_quantize(tt(y), tt(u), tt(g), bits=bits, pack=pack,
                               block=block, per_thread=v,
                               levels2=None if lv is None else tt(lv))
        np.testing.assert_array_equal(npy(out).astype(np.int64),
                                      npy(ref).astype(np.int64))


def test_quantize_grid_the_wrapper_reports():
    """8 outputs a thread, or 2 where 8 would start fewer than 2^17
    threads; CTAs of 256: the downlink's one 32,768-row and 16 rows of
    4-bit packed bytes at 2 a thread, a bench row and the bench shape at
    8."""
    def geo(ctas, per_thread):
        return {"ctas": ctas, "threads": 256, "per_thread": per_thread}
    assert kx.quantize_geometry(1, 32_768) == geo(64, 2)
    assert kx.quantize_geometry(16, 32_768, pack=2) == geo(512, 2)
    assert kx.quantize_geometry(16, 32_768) == geo(1024, 2)
    assert kx.quantize_geometry(2, 3072) == geo(12, 2)
    assert kx.quantize_geometry(1, 1 << 20) == geo(512, 8)
    assert kx.quantize_geometry(32, 1 << 20) == geo(16_384, 8)
    assert kx.quantize_geometry(300, 32_768, pack=4) == geo(1200, 8)
