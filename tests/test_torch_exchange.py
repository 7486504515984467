"""The four exchange kernels' plain versions (the CPU path of every
wrapper) against ``repro.kernels.exchange`` on the ``jnp`` backend and the
Pallas kernels in interpret mode, plus the packed wire layout.

Tolerances: pack, unpack, quantize and snap are exact on identical inputs;
rotation within 1e-5·max|y| (the port runs a butterfly, the reference two
matmuls: same function, other rounding); encode codes are equal except for
±1 mod L at no more than 1e-4 of the coordinates (where y/γ+u sits on an
integer boundary and the two rotations round to either side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import (circular_gap, gauss, npy, signs_np, tt,
                                uniform)
from repro.compression import pipeline as ref_pipe
from repro.kernels import exchange as ref_kx
from repro_torch.kernels import exchange as kx

# (bits, pack): unpacked 8-bit, and the packed 4- and 2-bit wires
WIRES = [(8, 1), (4, 2), (2, 4)]
D_PADS = [4096, 8192]          # 64x64 blocks, and r=128, c=64


def _ref_ops(kind):
    if kind == "jnp":
        return dict(rotate=ref_pipe._rotate_jnp, encode=ref_pipe._encode_jnp,
                    quantize=ref_pipe._quantize_jnp, snap=ref_pipe._snap_jnp)
    return dict(rotate=ref_kx.fused_rotate, encode=ref_kx.fused_encode,
                quantize=ref_kx.quantize_codes, snap=ref_kx.snap_codes)


def _unpacked(codes, bits, pack):
    codes = npy(codes)
    if pack == 1:
        return codes.astype(np.int64)
    return npy(kx.unpack_codes(tt(codes), bits=bits)).astype(np.int64)


def _gammas(y, bits, seed):
    """Scales at which y/γ spans the ring about four times, so the codes
    wrap and cover every level."""
    span = np.abs(y).max(axis=1)
    jitter = 1.0 + 0.1 * np.random.default_rng(seed).random(y.shape[0])
    return (span * jitter / (1 << bits) / 2).astype(np.float32)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("d_pad", D_PADS)
def test_pack_unpack_bytes_match_reference(bits, d_pad):
    codes = np.random.default_rng(bits).integers(
        0, 1 << bits, (3, d_pad)).astype(np.uint32)
    packed_ref = npy(ref_kx.pack_codes(jnp.asarray(codes), bits=bits))
    packed = kx.pack_codes(tt(codes.astype(np.int32)), bits=bits)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(npy(packed), packed_ref)
    unpacked = kx.unpack_codes(packed, bits=bits)
    np.testing.assert_array_equal(
        npy(unpacked), npy(ref_kx.unpack_codes(jnp.asarray(packed_ref),
                                               bits=bits)))
    np.testing.assert_array_equal(npy(unpacked), codes)


@pytest.mark.parametrize("kind", ["jnp", "interpret"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d_pad", D_PADS)
def test_rotate_matches_reference(kind, inverse, d_pad):
    x = gauss(1, (3, d_pad))
    sg = signs_np(2, d_pad)
    y_ref = npy(_ref_ops(kind)["rotate"](jnp.asarray(x), jnp.asarray(sg),
                                         inverse=inverse))
    y = npy(kx.fused_rotate(tt(x), tt(sg), inverse=inverse))
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()
    # orthogonal: the inverse undoes the forward
    back = kx.fused_rotate(kx.fused_rotate(tt(x), tt(sg)), tt(sg),
                           inverse=True)
    np.testing.assert_allclose(npy(back), x, atol=1e-5)


@pytest.mark.parametrize("kind", ["jnp", "interpret"])
@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("d_pad", D_PADS)
def test_encode_matches_reference(kind, bits, pack, d_pad):
    m = 4
    x = gauss(3, (m, d_pad))
    sg, u = signs_np(4, d_pad), uniform(5, (m, d_pad))
    y0 = npy(kx.rotate_plain(tt(x), tt(sg)))
    g = _gammas(y0, bits, 6)
    y_ref, c_ref = _ref_ops(kind)["encode"](
        jnp.asarray(x), jnp.asarray(sg), jnp.asarray(u), jnp.asarray(g),
        bits=bits, want_rotated=True, pack=pack)
    y, codes = kx.fused_encode(tt(x), tt(sg), tt(u), tt(g), bits=bits,
                               want_rotated=True, pack=pack)
    y_ref = npy(y_ref)
    assert np.abs(npy(y) - y_ref).max() <= 1e-5 * np.abs(y_ref).max()
    assert codes.dtype == (torch.int32 if pack == 1 else torch.uint8)
    assert tuple(codes.shape) == (m, d_pad // pack)
    a, b = _unpacked(codes, bits, pack), _unpacked(c_ref, bits, pack)
    gap = circular_gap(a, b, 1 << bits)
    assert gap.max() <= 1
    assert (gap > 0).mean() <= 1e-4
    assert len(np.unique(a)) == 1 << bits    # codes cover the ring


@pytest.mark.parametrize("kind", ["jnp", "interpret"])
@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("d_pad", D_PADS)
def test_quantize_exact(kind, bits, pack, d_pad):
    m = 3
    y = gauss(7, (m, d_pad), 0.05)
    u = uniform(8, (m, d_pad))
    g = _gammas(y, bits, 9)
    c_ref = _ref_ops(kind)["quantize"](jnp.asarray(y), jnp.asarray(u),
                                       jnp.asarray(g), bits=bits, pack=pack)
    codes = kx.quantize_codes(tt(y), tt(u), tt(g), bits=bits, pack=pack)
    np.testing.assert_array_equal(_unpacked(codes, bits, pack),
                                  _unpacked(c_ref, bits, pack))
    if pack > 1:
        np.testing.assert_array_equal(npy(codes), npy(c_ref))
    # the fused encode quantizes the same y to the same codes
    x = npy(kx.rotate_plain(tt(y), tt(np.ones(d_pad, np.float32)),
                            inverse=True))
    y2, c2 = kx.fused_encode(tt(x), tt(np.ones(d_pad, np.float32)), tt(u),
                             tt(g), bits=bits, want_rotated=True, pack=pack)
    c3 = kx.quantize_codes(y2, tt(u), tt(g), bits=bits, pack=pack)
    np.testing.assert_array_equal(npy(c2), npy(c3))


@pytest.mark.parametrize("kind", ["jnp", "interpret"])
@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("mc,mw", [(3, 1), (1, 3)])
@pytest.mark.parametrize("d_pad", D_PADS)
def test_snap_exact_with_broadcast(kind, bits, pack, mc, mw, d_pad):
    m = max(mc, mw)
    codes = np.random.default_rng(10).integers(0, 1 << bits, (mc, d_pad))
    packed = npy(kx.pack_codes(tt(codes.astype(np.int32)), bits=bits)) \
        if pack > 1 else codes.astype(np.int32)
    w = gauss(11, (mw, d_pad), 0.1)
    g = (np.full(mc, 0.01) * (1 + np.arange(mc))).astype(np.float32)
    ref_codes = packed if pack > 1 else codes.astype(np.uint32)
    q_ref = _ref_ops(kind)["snap"](jnp.asarray(ref_codes), jnp.asarray(w),
                                   jnp.asarray(g), bits=bits, pack=pack)
    q = kx.snap_codes(tt(packed), tt(w), tt(g), bits=bits, pack=pack)
    assert tuple(q.shape) == (m, d_pad)
    np.testing.assert_array_equal(npy(q), npy(q_ref))


@pytest.mark.parametrize("kind", ["jnp", "interpret"])
def test_levels_row_matches_reference(kind):
    """Per-message wrap moduli (the grouped codec's levels row) through
    encode, quantize and snap."""
    m, d_pad, bits = 3, 4096, 8
    levels = np.array([256.0, 16.0, 64.0], np.float32)
    x = gauss(12, (m, d_pad))
    sg, u = signs_np(13, d_pad), uniform(14, (m, d_pad))
    y0 = npy(kx.rotate_plain(tt(x), tt(sg)))
    g = (np.abs(y0).max(axis=1) * 4 / levels).astype(np.float32)
    ops = _ref_ops(kind)
    lv_j = jnp.asarray(levels)
    y_ref, c_ref = ops["encode"](jnp.asarray(x), jnp.asarray(sg),
                                 jnp.asarray(u), jnp.asarray(g), bits=bits,
                                 want_rotated=True, levels2=lv_j)
    y, codes = kx.fused_encode(tt(x), tt(sg), tt(u), tt(g), bits=bits,
                               want_rotated=True, levels2=tt(levels))
    gap = circular_gap(npy(codes), npy(c_ref), levels[:, None])
    assert gap.max() <= 1 and (gap > 0).mean() <= 1e-4
    assert (npy(codes) < levels[:, None]).all()

    q_ref = ops["quantize"](y_ref, jnp.asarray(u), jnp.asarray(g),
                            bits=bits, levels2=lv_j)
    q = kx.quantize_codes(tt(npy(y_ref)), tt(u), tt(g), bits=bits,
                          levels2=tt(levels))
    np.testing.assert_array_equal(npy(q), npy(q_ref))

    w = y0 + gauss(15, (m, d_pad), 1e-3)
    s_ref = ops["snap"](q_ref, jnp.asarray(w), jnp.asarray(g), bits=bits,
                        levels2=lv_j)
    s = kx.snap_codes(q, tt(w), tt(g), bits=bits, levels2=tt(levels))
    np.testing.assert_array_equal(npy(s), npy(s_ref))


# ---------------------------------------------------------------------------
# the rotated-space round's two fused snaps against the passes they replace
# ---------------------------------------------------------------------------

FUSED_WIRES = ["b8", "b4_packed", "levels"]


def _fused_inputs(s, wire, d_pad=4096, seed=20):
    """A round's rotated rows and codes: Y_rot (s, d_pad) near the rotated
    server (1, d_pad), the clients' codes at γ_up, the server's at γ_dn,
    and the (bits, pack, levels) of each direction."""
    srv = gauss(seed, (1, d_pad), 0.05)
    y = srv + gauss(seed + 1, (s, d_pad), 0.01)
    if wire == "b4_packed":
        up = (4, 2, None)
    elif wire == "levels":
        up = (8, 1, tt(np.resize(np.array([256.0, 16.0, 256.0, 64.0],
                                          np.float32), s)))
    else:
        up = (8, 1, None)
    dn = (8, 1, tt(np.array([64.0], np.float32)) if wire == "levels"
          else None)
    lv_up = (np.full(s, 1 << up[0], np.float32) if up[2] is None
             else npy(up[2]))
    g_up = (np.abs(y - srv).max(axis=1) * 4 / lv_up).astype(np.float32)
    lv_dn = float(1 << dn[0]) if dn[2] is None else float(npy(dn[2])[0])
    g_dn = np.array([np.abs(y - srv).max() * 4 / lv_dn], np.float32)
    codes_up = kx.quantize_plain(tt(y), tt(uniform(seed + 2, (s, d_pad))),
                                 tt(g_up), bits=up[0], pack=up[1],
                                 levels2=up[2])
    codes_dn = kx.quantize_plain(tt(srv), tt(uniform(seed + 3, (1, d_pad))),
                                 tt(g_dn), bits=dn[0], pack=dn[1],
                                 levels2=dn[2])
    return (tt(srv), tt(y), codes_up, tt(g_up), up, codes_dn, tt(g_dn), dn)


def _wire_kw(w):
    return dict(bits=w[0], pack=w[1], levels2=w[2])


@pytest.mark.parametrize("avg_mode", kx.AVG_MODES)
@pytest.mark.parametrize("wire", FUSED_WIRES)
@pytest.mark.parametrize("s", [1, 2, 16])
def test_fused_snaps_equal_the_passes_they_replace(s, wire, avg_mode):
    """``uplink`` and ``average`` (the CPU path of their wrappers) against
    the round's unfused composition: the snaps, the server average over
    ``torch.sum`` / ``torch.mean``, the differences, the norms and the
    in-place client average. Same order of operations (CPU sums over at
    most 16 rows run in row order), so the same bits."""
    srv, y, c_up, g_up, up, c_dn, g_dn, dn = _fused_inputs(s, wire)
    norms = lambda x: torch.linalg.vector_norm(x, dim=1)  # noqa: E731
    qy = kx.snap_plain(c_up, srv, g_up, **_wire_kw(up))
    if avg_mode in ("both", "server_only"):
        srv_want = (srv[0] + torch.sum(qy, 0)) / (s + 1)
    else:
        srv_want = torch.mean(qy, 0)
    rel_want = torch.mean(norms(qy - y) / (norms(y) + 1e-9))
    hint_want = torch.max(norms(qy - srv)) + 1e-8
    qx = kx.snap_plain(c_dn, y, g_dn, **_wire_kw(dn))
    if avg_mode in ("both", "client_only"):
        cl_want = qx.div_(s + 1).add_(y.clone().mul_(s).div_(s + 1))
    else:
        cl_want = qx

    srv_new, rel, hint = kx.uplink(c_up, srv, y, g_up, avg_mode=avg_mode,
                                   **_wire_kw(up))
    assert srv_new.shape == (y.shape[1],) and rel.shape == hint.shape == ()
    assert torch.equal(srv_new, srv_want)
    assert torch.equal(rel, rel_want) and torch.equal(hint, hint_want)
    y_in = y.clone()
    got = kx.average(c_dn, y_in, g_dn, avg_mode=avg_mode, **_wire_kw(dn))
    assert got is y_in and torch.equal(got, cl_want)
    assert kx.LAUNCHES["uplink"] == kx.LAUNCHES["average"] == 0


def test_fused_snaps_sum_the_rows_in_order():
    """Past 16 rows the CPU's ``torch.sum`` takes another order; the fused
    uplink sums the rows one after another, as the kernel does."""
    s = 33
    srv, y, c_up, g_up, up, _, _, _ = _fused_inputs(s, "b8")
    qy = kx.snap_plain(c_up, srv, g_up, **_wire_kw(up))
    acc = torch.zeros_like(srv[0])
    for i in range(s):
        acc = acc + qy[i]
    srv_new, _, _ = kx.uplink(c_up, srv, y, g_up, **_wire_kw(up))
    assert torch.equal(srv_new, (srv[0] + acc) / (s + 1))
    want = (srv[0] + torch.sum(qy, 0)) / (s + 1)
    assert float((srv_new - want).abs().max()) <= 1e-6 * float(
        want.abs().max())


def test_fused_snap_geometry_and_refusals():
    assert kx.uplink_geometry(2, 1_176_764_416) == {
        "ctas": 1056, "threads": 256, "per_thread": 8, "scratch": 3 * 2 * 1056}
    assert kx.uplink_geometry(16, 32_768) == {
        "ctas": 128, "threads": 256, "per_thread": 1, "scratch": 3 * 16 * 128}
    assert kx.uplink_geometry(16, 1 << 20)["per_thread"] == 8
    assert kx.uplink_geometry(1, 8)["ctas"] == 1
    assert kx.average_geometry(2, 1_176_764_416)["rows"] == 1
    assert kx.average_geometry(16, 32_768) == {"ctas": 256, "rows": 16,
                                               "threads": 256}
    assert kx.average_geometry(100_000, 2048)["rows"] == 1056
    srv, y, c_up, g_up, up, c_dn, g_dn, dn = _fused_inputs(2, "b8")
    with pytest.raises(ValueError, match="avg_mode"):
        kx.uplink(c_up, srv, y, g_up, avg_mode="mean")
    with pytest.raises(ValueError, match="avg_mode"):
        kx.average(c_dn, y, g_dn, avg_mode="mean")


def test_fused_snap_meta_branches():
    m, d = 3, 4096
    meta = dict(device="meta")
    y = torch.empty((m, d), **meta)
    srv = torch.empty((1, d), **meta)
    g = torch.empty((m,), **meta)
    codes = torch.empty((m, d), dtype=torch.int32, **meta)
    srv_new, rel, hint = kx.uplink(codes, srv, y, g)
    assert srv_new.shape == (d,) and rel.shape == hint.shape == ()
    assert {t.device.type for t in (srv_new, rel, hint)} == {"meta"}
    assert kx.average(codes[:1], y, g[:1]) is y
    with pytest.raises(ValueError, match="meta tensors only together"):
        kx.uplink(codes, torch.zeros((1, d)), y, g)
