"""The CUDA kernels on the card: each against its plain version, the launch
counters, and the wrappers' refusals. Needs a CUDA device and nvcc, and
skips without them. The card's machine has no JAX, so run this file there
without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import contextlib

import pytest
import torch

from repro_torch.compression.rotation import pad_len, signs
from repro_torch.kernels import exchange as kx
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_mm as gm
from repro_torch.kernels import hadamard as hd
from repro_torch.kernels import lattice_quant as lq
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

WIRES = [(8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(dev, m, d_pad, bits, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((m, d_pad), generator=g, device=dev)
    sg = signs(g, d_pad)
    u = torch.rand((m, d_pad), generator=g, device=dev)
    y = kx.rotate_plain(x, sg)
    gam = (y.abs().amax(dim=1) / (1 << bits) / 2).contiguous()
    return x, sg, u, gam


@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("m,d_pad", [(4, 4096), (3, 8192), (16, 32_768)])
def test_kernels_match_plain_versions(dev, m, d_pad, bits, pack):
    x, sg, u, gam = _inputs(dev, m, d_pad, bits)
    for inverse in (False, True):
        assert torch.equal(kx.fused_rotate(x, sg, inverse=inverse),
                           kx.rotate_plain(x, sg, inverse=inverse))
    kw = dict(bits=bits, pack=pack)
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
    y_p, codes_p = kx.encode_plain(x, sg, u, gam, want_rotated=True, **kw)
    assert torch.equal(y, y_p) and torch.equal(codes, codes_p)
    assert torch.equal(kx.quantize_codes(y, u, gam, **kw), codes)
    ref = y[:1] + 0.3 * gam[0]
    assert torch.equal(kx.snap_codes(codes, ref, gam, **kw),
                       kx.snap_plain(codes, ref, gam, **kw))
    one = codes[:1].contiguous()
    assert torch.equal(kx.snap_codes(one, y, gam[:1].contiguous(), **kw),
                       kx.snap_plain(one, y, gam[:1], **kw))


def test_levels_row_matches_plain_version(dev):
    m, d_pad, bits = 3, 4096, 8
    x, sg, u, gam = _inputs(dev, m, d_pad, bits)
    lv = torch.tensor([256.0, 16.0, 64.0], device=dev)
    kw = dict(bits=bits, levels2=lv)
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
    assert torch.equal(codes, kx.encode_plain(x, sg, u, gam, **kw))
    assert bool((codes < lv[:, None]).all())
    assert torch.equal(kx.quantize_codes(y, u, gam, **kw), codes)
    assert torch.equal(kx.snap_codes(codes, y, gam, **kw),
                       kx.snap_plain(codes, y, gam, **kw))


def _decode_case(dev, m, d_pad, bits, pack, sign_rows=False, seed=0):
    """Codes of x under (m, d_pad) or (d_pad,) signs, and references x plus
    a perturbation inside the wrap window."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = (torch.randn((1, d_pad), generator=g, device=dev)
         + 0.05 * torch.randn((m, d_pad), generator=g, device=dev))
    sg = (signs(g, m * d_pad).reshape(m, d_pad) if sign_rows
          else signs(g, d_pad))
    u = torch.rand((m, d_pad), generator=g, device=dev)
    y = kx.rotate_plain(x, sg)
    gam = (y.abs().amax(dim=1) / (1 << bits) / 2).contiguous()
    codes = kx.fused_encode(x, sg, u, gam, bits=bits, pack=pack)
    ref = x + 0.1 * gam[:, None] * torch.randn((m, d_pad), generator=g,
                                               device=dev)
    return x, sg, u, gam, codes, ref


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2)])
@pytest.mark.parametrize("m,d_pad,sign_rows", [(4, 4096, False),
                                               (4, 8192, True),
                                               (16, 32_768, True)])
def test_fused_decode_matches_plain_version(dev, m, d_pad, sign_rows, bits,
                                            pack):
    x, sg, _, gam, codes, ref = _decode_case(dev, m, d_pad, bits, pack,
                                             sign_rows)
    kw = dict(bits=bits, pack=pack)
    cases = [(codes, ref[:1].contiguous(), gam), (codes, ref, gam)]
    if not sign_rows:
        cases.append((codes[:1].contiguous(), ref, gam[:1].contiguous()))
    for c, r, g in cases:
        out = kx.fused_decode(c, r, sg, g, **kw)
        assert torch.equal(out, kx.decode_plain(c, r, sg, g, **kw))
        assert out.shape == (m, d_pad)


def test_fused_decode_levels_row(dev):
    x, sg, u, gam, _, ref = _decode_case(dev, 3, 4096, 8, 1)
    lv = torch.tensor([256.0, 16.0, 64.0], device=dev)
    codes = kx.fused_encode(x, sg, u, gam, levels2=lv)
    assert torch.equal(kx.fused_decode(codes, ref, sg, gam, levels2=lv),
                       kx.decode_plain(codes, ref, sg, gam, levels2=lv))


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2)])
def test_fused_encode_with_sign_rows(dev, bits, pack):
    x, sg, u, gam, codes, _ = _decode_case(dev, 16, 32_768, bits, pack,
                                           sign_rows=True)
    assert torch.equal(codes, kx.encode_plain(x, sg, u, gam, bits=bits,
                                              pack=pack))
    y, _ = kx.fused_encode(x, sg, u, gam, bits=bits, pack=pack,
                           want_rotated=True)
    assert torch.equal(y, kx.rotate_plain(x, sg))


def test_each_wrapper_counts_its_launches(dev):
    x, sg, u, gam = _inputs(dev, 2, 4096, 8)
    kx.reset_launches()
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True)
    kx.fused_rotate(y, sg, inverse=True)
    kx.quantize_codes(y, u, gam)
    kx.snap_codes(codes, y, gam)
    kx.fused_decode(codes, x, sg, gam)
    kx.uplink(codes, y[:1].contiguous(), y, gam)
    kx.average(codes[:1].contiguous(), y.clone(), gam[:1].contiguous())
    kx.rotate_plain(x, sg)
    kx.decode_plain(codes, x, sg, gam)
    kx.uplink_plain(codes, y[:1], y, gam)
    kx.average_plain(codes[:1], y.clone(), gam[:1])
    torch.cuda.synchronize()
    assert kx.LAUNCHES == {"fused_encode": 1, "fused_rotate": 1,
                           "quantize_codes": 1, "snap_codes": 1,
                           "fused_decode": 1, "uplink": 1, "average": 1}


def test_decode_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, sg, u, gam = _inputs(dev, 2, 4096, 8)
    codes = kx.fused_encode(x, sg, u, gam)
    kx.reset_launches()
    with pytest.raises(TypeError, match="int32"):
        kx.fused_decode(codes.to(torch.int64), x, sg, gam)
    with pytest.raises(TypeError, match="float32"):
        kx.fused_decode(codes, x.double(), sg, gam)
    with pytest.raises(ValueError, match="broadcast"):
        kx.fused_decode(codes, x[:, :2048].contiguous(), sg, gam)
    with pytest.raises(ValueError, match="shape"):
        kx.fused_decode(codes, x, sg[None].repeat(3, 1), gam)
    with pytest.raises(ValueError, match="CPU or all"):
        kx.fused_decode(codes, x, sg.cpu(), gam)
    with pytest.raises(ValueError, match="contiguous"):
        kx.fused_decode(codes, x.t().contiguous().t(), sg, gam)
    with pytest.raises(ValueError, match="messages"):
        kx.fused_decode(codes, x, sg, torch.ones(3, device=dev))
    torch.cuda.synchronize()
    assert kx.LAUNCHES["fused_decode"] == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, sg, u, gam = _inputs(dev, 2, 4096, 8)
    kx.reset_launches()
    with pytest.raises(TypeError, match="float32"):
        kx.fused_rotate(x.double(), sg)
    with pytest.raises(ValueError, match="contiguous"):
        kx.fused_rotate(x.t().contiguous().t(), sg)
    with pytest.raises(ValueError, match="CPU or all"):
        kx.fused_rotate(x, sg.cpu())
    with pytest.raises(ValueError, match="shape"):
        kx.fused_rotate(x, sg[:2048])
    with pytest.raises(ValueError, match="messages"):
        kx.fused_encode(x, sg, u, gam[:1].contiguous())
    codes = kx.quantize_codes(x, u, gam)          # int32, unpacked
    with pytest.raises(TypeError, match="uint8"):
        kx.snap_codes(codes[:, :2048].contiguous(), x, gam, bits=4, pack=2)
    with pytest.raises(ValueError, match="pack"):
        kx.quantize_codes(x, u, gam, bits=8, pack=2)
    torch.cuda.synchronize()
    assert kx.LAUNCHES["fused_rotate"] == 0
    assert kx.LAUNCHES["fused_encode"] == 0


# ---------------------------------------------------------------------------
# the cluster kernels of fused_encode and fused_decode, bit for bit
# ---------------------------------------------------------------------------

CLUSTER_SHAPES = [(m, d) for m in (1, 16, 300)
                  for d in (4096, 8192, 32_768, 1 << 20)]


def _ref_rows(dev, x, gam, seed=1):
    """References near x: x + 0.1 γ N(0, 1), one row per message."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return x + 0.1 * gam[:, None] * torch.randn(x.shape, generator=g,
                                                device=dev)


def _decode_cases(codes, ref, gam, lv=None):
    """(codes, refs, γ, levels): m codes against m references, m codes
    against one reference, one code row against m references."""
    one = (lambda t: None if t is None else t[:1].contiguous())
    return [(codes, ref, gam, lv), (codes, one(ref), gam, lv),
            (one(codes), ref, one(gam), one(lv))]


@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("m,d_pad", CLUSTER_SHAPES)
def test_cluster_kernels_equal_plain_versions(dev, m, d_pad, bits, pack):
    x, sg, u, gam = _inputs(dev, m, d_pad, bits)
    kw = dict(bits=bits, pack=pack)
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
    y_p, codes_p = kx.encode_plain(x, sg, u, gam, want_rotated=True, **kw)
    assert torch.equal(y, y_p) and torch.equal(codes, codes_p)
    assert torch.equal(kx.fused_encode(x, sg, u, gam, **kw), codes_p)
    del y, y_p, u
    ref = _ref_rows(dev, x, gam)
    for c, r, g, _ in _decode_cases(codes, ref, gam):
        assert torch.equal(kx.fused_decode(c, r, sg, g, **kw),
                           kx.decode_plain(c, r, sg, g, **kw))
    torch.cuda.synchronize()


# (m, d_pad, block): every cluster size the wrapper picks (1 at b <= 2,048,
# then 2, 4, 8) and the 4,096-coordinate chunks of b = 32,768
CLUSTER_GEOMETRIES = [(3, 32, 16_384), (3, 1024, 16_384), (5, 2048, 16_384),
                      (5, 4096, 16_384), (5, 8192, 16_384),
                      (5, 32_768, 16_384), (3, 65_536, 32_768)]


@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("m,d_pad,block", CLUSTER_GEOMETRIES)
def test_cluster_sizes_sign_rows_and_levels(dev, m, d_pad, block, bits,
                                            pack):
    b, _, r, _, _ = kx.block_geometry(d_pad, block)
    geo = kx.launch_geometry(m, d_pad, block=block, pack=pack)
    assert geo["cluster"] == kx.cluster_size(b, r, pack)
    x, _, u, gam = _inputs(dev, m, d_pad, bits)
    g = torch.Generator(device=dev)
    g.manual_seed(d_pad)
    sg_rows = signs(g, m * d_pad).reshape(m, d_pad)
    lv = {8: [256.0, 16.0, 64.0, 2.0, 32.0],
          4: [16.0, 4.0, 8.0, 2.0, 16.0]}.get(bits)
    lv = None if lv is None else torch.tensor(lv[:m], device=dev)
    kw = dict(bits=bits, pack=pack, block=block)
    for sg in (sg_rows, sg_rows[0].contiguous()):
        y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True,
                                   levels2=lv, **kw)
        y_p, codes_p = kx.encode_plain(x, sg, u, gam, want_rotated=True,
                                       levels2=lv, **kw)
        assert torch.equal(y, y_p) and torch.equal(codes, codes_p)
        ref = _ref_rows(dev, x, gam)
        for c, r_, g_, lv_ in _decode_cases(codes, ref, gam, lv):
            assert torch.equal(
                kx.fused_decode(c, r_, sg, g_, levels2=lv_, **kw),
                kx.decode_plain(c, r_, sg, g_, levels2=lv_, **kw))
    torch.cuda.synchronize()


def test_cluster_kernels_are_deterministic(dev):
    """Two calls give the same bits (a stale read of a peer's shared memory
    would show as a rare difference)."""
    for m in (16, 300):
        x, sg, u, gam = _inputs(dev, m, 32_768, 4, seed=m)
        ref = _ref_rows(dev, x, gam)
        kw = dict(bits=4, pack=2)
        one = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
        two = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
        d1 = kx.fused_decode(one[1], ref, sg, gam, **kw)
        d2 = kx.fused_decode(one[1], ref, sg, gam, **kw)
        assert torch.equal(d1, d2)
    torch.cuda.synchronize()


def test_cluster_kernels_refuse_a_block_past_shared_memory(dev):
    """_MAX_SHARED_BLOCK refuses as before: a 65,536-block, unlaunched."""
    x, sg, u, gam = _inputs(dev, 2, 65_536, 8)
    codes = kx.encode_plain(x, sg, u, gam)
    kx.reset_launches()
    with pytest.raises(ValueError, match="exceeds"):
        kx.fused_encode(x, sg, u, gam, block=65_536)
    with pytest.raises(ValueError, match="exceeds"):
        kx.fused_decode(codes, x, sg, gam, block=65_536)
    torch.cuda.synchronize()
    assert kx.LAUNCHES["fused_encode"] == 0
    assert kx.LAUNCHES["fused_decode"] == 0


# ---------------------------------------------------------------------------
# fused_rotate's cluster kernel and snap_codes' vectorised kernel
# ---------------------------------------------------------------------------

# (d_pad, block): cluster sizes 1 (b = 32 and 2,048), 2, 4 and 8, and the
# 4,096-coordinate chunks of b = 32,768
ROTATE_GEOMETRIES = [(128, 32), (2048, 16_384), (4096, 16_384),
                     (8192, 16_384), (32_768, 16_384), (65_536, 32_768)]


@pytest.mark.parametrize("m", [1, 16, 32])
@pytest.mark.parametrize("d_pad,block", ROTATE_GEOMETRIES)
def test_cluster_rotate_equals_plain_version(dev, d_pad, block, m):
    x, sg, _, _ = _inputs(dev, m, d_pad, 8, seed=d_pad + m)
    kx.reset_launches()
    for inverse in (False, True):
        out = kx.fused_rotate(x, sg, block=block, inverse=inverse)
        assert torch.equal(out, kx.rotate_plain(x, sg, block=block,
                                                inverse=inverse))
    torch.cuda.synchronize()
    assert kx.LAUNCHES["fused_rotate"] == 2
    b, _, r, _, _ = kx.block_geometry(d_pad, block)
    assert kx.launch_geometry(m, d_pad, block=block)["cluster"] == \
        kx.cluster_size(b, r, 1)


def _snap_case(dev, m, d_pad, bits, pack, block, levels, seed=0):
    """m code rows of x's encode (packed when pack > 1), references near
    the rotated x, γ, and a levels row when asked."""
    x, sg, u, gam = _inputs(dev, m, d_pad, bits, seed=seed)
    lv = None
    if levels:
        top = torch.tensor([1 << bits, max(1, (1 << bits) // 4),
                            max(1, (1 << bits) // 2)], device=dev)
        lv = top.repeat(m)[:m].to(torch.float32)
    kw = dict(bits=bits, pack=pack, block=block, levels2=lv)
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
    return codes, _ref_rows(dev, y, gam, seed=seed + 1), gam, kw


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("d_pad,block", [(128, 32), (32_768, 16_384)])
@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (1, 8)])
def test_snap_kernel_equals_plain_version(dev, bits, pack, d_pad, block,
                                          levels):
    codes, w, gam, kw = _snap_case(dev, 16, d_pad, bits, pack, block,
                                   levels)
    lv = kw.pop("levels2")
    for c, r, g, lv_ in _decode_cases(codes, w, gam, lv):
        out = kx.snap_codes(c, r, g, levels2=lv_, **kw)
        assert out.shape == (16, d_pad)
        assert torch.equal(out, kx.snap_plain(c, r, g, levels2=lv_, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (1, 8)])
def test_snap_unaligned_views_take_the_scalar_path(dev, bits, pack):
    """Codes and references at offsets that break the 16- and 8-byte loads
    give the plain version's values."""
    codes, w, gam, kw = _snap_case(dev, 4, 32_768, bits, pack, 16_384,
                                   False)
    kw.pop("levels2")
    for c, r, g, _ in _decode_cases(codes, w, gam):
        want = kx.snap_plain(c, r, g, **kw)
        assert torch.equal(kx.snap_codes(_shifted(c, 1), _shifted(r, 1), g,
                                         **kw), want)
    torch.cuda.synchronize()


def test_rotate_and_snap_kernels_are_deterministic(dev):
    """Two calls give the same bits (a stale read of a peer's shared memory
    would show as a rare difference)."""
    for m in (1, 16, 32):
        x, sg, _, _ = _inputs(dev, m, 32_768, 8, seed=m)
        for inverse in (False, True):
            assert torch.equal(kx.fused_rotate(x, sg, inverse=inverse),
                               kx.fused_rotate(x, sg, inverse=inverse))
    codes, w, gam, kw = _snap_case(dev, 16, 32_768, 4, 2, 16_384, False)
    kw.pop("levels2")
    for c, r, g, _ in _decode_cases(codes, w, gam):
        assert torch.equal(kx.snap_codes(c, r, g, **kw),
                           kx.snap_codes(c, r, g, **kw))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the rotated-space round's fused snaps: uplink and average
# ---------------------------------------------------------------------------

# (d_pad, block): at 1 coordinate a thread (d_pad < 2^20, 256 a CTA), a
# lone partial CTA (20), a partial last CTA (2,068 = 8 · 256 + 20), whole
# CTAs at b = 1,024 (3,072) and the MLP's 32,768, and 2^19, twice the CTAs
# of one wave (each strides); at 8 a thread (2,048 a CTA), a partial vector
# in a partial CTA (2^20 + 20) and 2^22, again two chunks a CTA
FUSED_GEOMETRIES = [(20, 4), (2068, 4), (3072, 1024), (32_768, 16_384),
                    (1 << 19, 16_384), ((1 << 20) + 20, 4), (1 << 22, 16_384)]


def _fused_case(dev, s, d_pad, block, wire, seed=0):
    """Rotated server (1, d_pad) and client rows (s, d_pad) near it, the
    clients' codes at γ_up (b8, b4 packed, or a levels row) and the
    server's at γ_dn, with each direction's keyword arguments."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    srv = torch.randn((1, d_pad), generator=g, device=dev)
    y = srv + 0.1 * torch.randn((s, d_pad), generator=g, device=dev)
    bits, pack = (4, 2) if wire == "b4_packed" else (8, 1)
    lv_up = lv_dn = None
    if wire == "levels":
        lv_up = torch.tensor([256.0, 16.0, 64.0], device=dev).repeat(s)[:s]
        lv_dn = torch.tensor([64.0], device=dev)
    up = dict(bits=bits, pack=pack, levels2=lv_up, block=block)
    dn = dict(bits=8, pack=1, levels2=lv_dn, block=block)
    L_up = lv_up if lv_up is not None else torch.full(
        (s,), float(1 << bits), device=dev)
    g_up = ((y - srv).abs().amax(dim=1) * 4 / L_up).contiguous()
    L_dn = 64.0 if lv_dn is not None else 256.0
    g_dn = ((y - srv).abs().amax() * 4 / L_dn).reshape(1)
    u = torch.rand((s + 1, d_pad), generator=g, device=dev)
    c_up = kx.quantize_plain(y, u[:s], g_up, **up)
    c_dn = kx.quantize_plain(srv, u[s:], g_dn, **dn)
    return srv, y, c_up, g_up, up, c_dn, g_dn, dn


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("avg_mode", ["both", "client_only", "none"])
@pytest.mark.parametrize("wire", ["b8", "b4_packed", "levels"])
@pytest.mark.parametrize("s", [1, 2, 16, 40])
@pytest.mark.parametrize("d_pad,block", FUSED_GEOMETRIES)
def test_fused_snap_kernels_equal_plain_versions(dev, d_pad, block, s, wire,
                                                 avg_mode):
    """``uplink`` and ``average`` against their plain versions: the server
    average and the clients' average bit for bit, rel_err and hint_srv
    within 1e-5 relative (the kernel sums squares per warp, per CTA and
    over CTAs; torch another way). s = 40 takes the rows in two groups."""
    srv, y, c_up, g_up, up, c_dn, g_dn, dn = _fused_case(dev, s, d_pad,
                                                         block, wire)
    kx.reset_launches()
    got = kx.uplink(c_up, srv, y, g_up, avg_mode=avg_mode, **up)
    want = kx.uplink_plain(c_up, srv, y, g_up, avg_mode=avg_mode, **up)
    assert torch.equal(got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-5 and _rel(got[2], want[2]) <= 1e-5
    y_in = y.clone()
    out = kx.average(c_dn, y_in, g_dn, avg_mode=avg_mode, **dn)
    assert out is y_in
    assert torch.equal(out, kx.average_plain(c_dn, y.clone(), g_dn,
                                             avg_mode=avg_mode, **dn))
    torch.cuda.synchronize()
    assert kx.LAUNCHES["uplink"] == kx.LAUNCHES["average"] == 1


def test_fused_uplink_takes_more_messages_than_a_finish_pass(dev):
    """s = 1,030: the uplink's rows in 33 groups, its finish in two passes
    of at most 1,024 messages."""
    srv, y, c_up, g_up, up, _, _, _ = _fused_case(dev, 1030, 3072, 1024,
                                                  "levels")
    got = kx.uplink(c_up, srv, y, g_up, **up)
    want = kx.uplink_plain(c_up, srv, y, g_up, **up)
    assert torch.equal(got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-5 and _rel(got[2], want[2]) <= 1e-5


def test_fused_snap_kernels_are_deterministic(dev):
    """Two launches give the same bits: the partial sums run in a fixed
    order, without atomics."""
    for s, d_pad in ((2, 1 << 22), (16, 32_768), (40, 3072)):
        srv, y, c_up, g_up, up, c_dn, g_dn, dn = _fused_case(
            dev, s, d_pad, 16_384 if d_pad > 4096 else 1024, "b8", seed=s)
        a = kx.uplink(c_up, srv, y, g_up, **up)
        b = kx.uplink(c_up, srv, y, g_up, **up)
        for x1, x2 in zip(a, b):
            assert torch.equal(x1, x2)
        assert torch.equal(kx.average(c_dn, y.clone(), g_dn, **dn),
                           kx.average(c_dn, y.clone(), g_dn, **dn))
    torch.cuda.synchronize()


def test_fused_snap_wrappers_refuse_what_the_kernels_do_not_take(dev):
    srv, y, c_up, g_up, up, c_dn, g_dn, dn = _fused_case(dev, 2, 4096, 4096,
                                                         "b8")
    kx.reset_launches()
    with pytest.raises(TypeError, match="uint8"):
        kx.uplink(c_up, srv, y, g_up, bits=4, pack=2)
    with pytest.raises(ValueError, match="shape"):
        kx.uplink(c_up, y, y, g_up)                 # two server rows
    with pytest.raises(ValueError, match="shape"):
        kx.uplink(c_up[:1].contiguous(), srv, y, g_up)
    with pytest.raises(ValueError, match="messages"):
        kx.uplink(c_up, srv, y, torch.ones(3, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        kx.uplink(c_up, srv, y.t().contiguous().t(), g_up)
    with pytest.raises(ValueError, match="avg_mode"):
        kx.uplink(c_up, srv, y, g_up, avg_mode="mean")
    with pytest.raises(ValueError, match="CPU or all"):
        kx.uplink(c_up, srv.cpu(), y, g_up)
    with pytest.raises(ValueError, match="shape"):
        kx.average(c_up, y, g_dn)                   # two code rows
    with pytest.raises(ValueError, match="2 values for 1 messages"):
        kx.average(c_dn, y, g_up)
    with pytest.raises(TypeError, match="float32"):
        kx.average(c_dn, y.double(), g_dn)
    with pytest.raises(ValueError, match="avg_mode"):
        kx.average(c_dn, y, g_dn, avg_mode="mean")
    torch.cuda.synchronize()
    assert kx.LAUNCHES["uplink"] == kx.LAUNCHES["average"] == 0


def _exchange_cu_kernels():
    import re
    from pathlib import Path
    src = (Path(kx.__file__).parent / "csrc" / "exchange.cu").read_text()
    return set(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?"
                          r"\s+(\w+)\(", src))


def test_quafl_round_launches_only_counted_exchange_kernels(dev):
    """One rotated-space round at (2, 2^22) under the profiler: every
    kernel of ``exchange.cu`` it launches is one the benchmark's
    ``exchange_ms_per_round`` counts (its family rule), the fused snaps
    among them; with spans on, the uplink's wrapper counts one
    ``exchange.fused_average``; rel_err and hint_srv match the unfused
    composition (the snap kernel, the differences and torch's norms)
    within 1e-5."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.metrics.exchange_ms_per_round import member
    from repro_torch.compression import pipeline
    from repro_torch.utils import spans
    s, d = 2, 1 << 22
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    server = torch.randn((d,), generator=g, device=dev) * 0.05
    Y = server + 0.01 * torch.randn((s, d), generator=g, device=dev)
    hints = torch.linalg.vector_norm(Y - server, dim=1)
    sg, u_cl, u_srv = pipeline.round_randomness(g, s, d)
    p = pipeline.ExchangePipeline(bits=8, backend="cuda")
    kw = dict(signs=sg, u_cl=u_cl, u_srv=u_srv)
    p.quafl_round(server, Y, hints, **kw)           # builds, warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, hint_srv, rel_err = p.quafl_round(server, Y, hints, **kw)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = _exchange_cu_kernels()
    assert {"snap_vec_kernel_up_average", "snap_vec_kernel_up_finish",
            "snap_vec_kernel_down_average"} <= ours
    launched = [n for n in names if any(k in n for k in ours)]
    assert launched and all(member(n) for n in launched), launched
    for k in ("snap_vec_kernel_up_average", "snap_vec_kernel_up_finish",
              "snap_vec_kernel_down_average"):
        assert any(k in n for n in launched), (k, launched)
    with spans.recording() as log:
        p.quafl_round(server, Y, hints, **kw)
    assert log.summary()["counters"] == {"exchange.fused_average": 1.0}

    norms = pipeline._norms
    gam_up = p.gammas(hints, norms(Y), d)
    Y_rot, codes = p.rotate_encode(Y, sg, u_cl, gam_up)
    srv_rot = p.rotate(server[None], sg)
    qy = p.snap(codes, srv_rot, gam_up)
    want_rel = torch.mean(norms(qy - Y_rot) / (norms(Y_rot) + 1e-9))
    want_hint = torch.max(norms(qy - srv_rot)) + 1e-8
    assert _rel(rel_err, want_rel) <= 1e-5
    assert _rel(hint_srv, want_hint) <= 1e-5


# ---------------------------------------------------------------------------
# quantize_codes' vectorised kernel
# ---------------------------------------------------------------------------

# (d_pad, block): c < 8 (b = 32, (8, 4)) with packed rows not a multiple of
# 8 bytes (96 / pack), a tail CTA (3,072 / pack outputs) at b = 1,024, the
# paths' 32,768 and one bench row
QUANTIZE_GEOMETRIES = [(96, 32), (128, 32), (3072, 1024), (32_768, 16_384),
                       (1 << 20, 16_384)]


@pytest.mark.parametrize("gam_rows,levels", [(True, None), (False, None),
                                             (True, "rows"), (False, "one")])
@pytest.mark.parametrize("d_pad,block", QUANTIZE_GEOMETRIES)
@pytest.mark.parametrize("bits,pack", WIRES)
def test_quantize_kernel_equals_plain_and_encode(dev, bits, pack, d_pad,
                                                 block, gam_rows, levels):
    """quantize_codes on the rotated y equals quantize_plain and
    fused_encode's codes, with γ and levels rows of m values or one, at the
    wrapper's count of outputs a thread and at each other."""
    m = 3
    g = torch.Generator(device=dev)
    g.manual_seed(d_pad + pack)
    x = torch.randn((m, d_pad), generator=g, device=dev)
    u = torch.rand((m, d_pad), generator=g, device=dev)
    sg = signs(g, d_pad)
    kw = dict(bits=bits, pack=pack, block=block)
    y = kx.rotate_plain(x, sg, block=block)
    gam = (y.abs().amax(dim=1) / (1 << bits) / 2).contiguous()
    lv = None
    if levels == "rows":
        lv = torch.tensor([1 << bits, max(1, (1 << bits) // 4),
                           max(1, (1 << bits) // 2)], device=dev).float()
    elif levels == "one":
        lv = torch.tensor([max(1, (1 << bits) // 2)], device=dev).float()
    if not gam_rows:
        gam = gam[:1].contiguous()
    full = (lambda t: None if t is None
            else t.expand(m).contiguous())          # one value -> m rows
    y_e, codes_e = kx.fused_encode(x, sg, u, full(gam), want_rotated=True,
                                   levels2=full(lv), **kw)
    assert torch.equal(y_e, y)
    kx.reset_launches()
    codes = kx.quantize_codes(y, u, gam, levels2=lv, **kw)
    torch.cuda.synchronize()
    assert kx.LAUNCHES["quantize_codes"] == 1
    assert codes.shape == (m, d_pad // pack)
    assert torch.equal(codes, kx.quantize_plain(y, u, gam, levels2=lv, **kw))
    assert torch.equal(codes, codes_e)
    for v in (2, 8):                # every count of outputs a thread
        assert torch.equal(kx._launch_quantize(y, u, gam, bits, block, pack,
                                               lv, v), codes)


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2), (1, 8)])
def test_quantize_unaligned_views_take_the_scalar_path(dev, bits, pack):
    """y and u at offsets that break the 16-byte loads give the plain
    version's codes."""
    x, sg, u, gam = _inputs(dev, 4, 32_768, bits)
    y = kx.rotate_plain(x, sg)
    want = kx.quantize_plain(y, u, gam, bits=bits, pack=pack)
    for k in (1, 2):
        ys, us = _shifted(y, k), _shifted(u, k)
        assert torch.equal(kx.quantize_codes(ys, us, gam, bits=bits,
                                             pack=pack), want)
        for v in (2, 8):
            assert torch.equal(kx._launch_quantize(
                ys, us, gam, bits, 16_384, pack, None, v), want)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# hadamard_blocks' cluster kernel
# ---------------------------------------------------------------------------

# the 2^25 shape, b = 32,768, blocks under 8 coordinates, one row
HADAMARD_CLUSTER_SHAPES = [(2048, 128, 128), (3, 256, 128), (5, 2, 2),
                           (3, 1, 4), (4, 1, 1), (2, 1, 8192), (3, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,c", HADAMARD_CLUSTER_SHAPES)
def test_hadamard_cluster_kernel_equals_plain_version(dev, n, r, c, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(n + r * c)
    x = torch.randn((n, r, c), generator=g, device=dev).to(dtype)
    hd.reset_launches()
    out = hd.hadamard_blocks(x)
    torch.cuda.synchronize()
    assert hd.LAUNCHES == {"hadamard_blocks": 1}
    assert torch.equal(out, hd.hadamard_plain(x))
    assert torch.equal(hd.hadamard_blocks(x), out)      # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hadamard_every_cluster_size_and_unaligned_views(dev, dtype):
    """Each cluster size the kernel takes gives the plain version's bits at
    b = 16,384 (C = 2, 4, 8), and inputs at an offset that breaks the
    16-byte loads take the scalar path to the same bits."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    x = torch.randn((5, 128, 128), generator=g, device=dev).to(dtype)
    want = hd.hadamard_plain(x)
    for cl in (2, 4, 8):
        assert torch.equal(hd._launch(x, cl), want)
    for k in (1, 3):
        assert torch.equal(hd.hadamard_blocks(_shifted(x, k)), want)
    with pytest.raises(RuntimeError, match="hadamard_blocks_fwd"):
        hd._launch(x, 1)                # a chunk of 16,384: refused
    torch.cuda.synchronize()


# (b, t, h, kv, dh, window, softcap): the serve path's shapes, cut in
# length, and the head dims of the reduced configs
FLASH_CASES = [(2, 512, 8, 4, 256, 0, 50.0), (2, 512, 8, 4, 256, 128, 50.0),
               (1, 384, 32, 8, 64, 0, 0.0), (1, 256, 16, 16, 128, 0, 0.0),
               (2, 200, 4, 1, 32, 64, 30.0), (1, 128, 4, 2, 16, 0, 0.0)]


def _qkv(dev, b, t, h, kv, dh, dtype, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, t, h, dh), (b, t, kv, dh), (b, t, kv, dh)))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,t,h,kv,dh,window,cap", FLASH_CASES)
def test_flash_kernel_matches_plain_version(dev, b, t, h, kv, dh, window,
                                            cap, dtype, tol):
    q, k, v = _qkv(dev, b, t, h, kv, dh, dtype)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, window=window, softcap=cap)
    want = fa.flash_attention_plain(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1}
    assert out.dtype == dtype and out.shape == q.shape
    assert float((out.float() - want.float()).abs().max()) <= tol


def _assert_bf16_gates(out, want):
    """chip_smoke.py's bf16 gates: max |Δ| ≤ 3e-2, per row of dh outputs
    max |Δ| ≤ 2^-7·max|want_row| + 1e-3, ‖Δ‖ ≤ 1e-2·‖want‖."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    row_excess = err.amax(-1) - (2.0 ** -7 * want.abs().amax(-1) + 1e-3)
    rel = float(torch.linalg.vector_norm(err)
                / torch.linalg.vector_norm(want))
    assert bool(torch.isfinite(out).all())
    assert float(err.max()) <= 3e-2 and float(row_excess.max()) <= 0.0 \
        and rel <= 1e-2, (float(err.max()), float(row_excess.max()), rel)


# (b, t, h, kv, dh, window, softcap) for the tensor-core kernel's tiling:
# ragged lengths (200, 320: the last 128-query and 64-key tiles cut short),
# window edges that cross a 64-key tile, GQA groups 1, 2, 4 and 8; then
# llama4-scout's global layers (h 40, kv 8: a group of 5) and gemma3-12b's
# local layers (h 16, kv 8, dh 256, window 1,024)
WGMMA_CASES = [(2, 200, 8, 4, 256, 0, 50.0), (1, 320, 8, 4, 256, 0, 50.0),
               (2, 320, 8, 4, 256, 100, 50.0), (1, 512, 8, 4, 256, 160, 50.0),
               (1, 320, 4, 2, 128, 37, 30.0)] + [
    (2, 256, 8, kv, 128, 0, 50.0) for kv in (8, 4, 2, 1)] + [
    (2, 512, 40, 8, 128, 0, 0.0), (1, 320, 40, 8, 128, 0, 0.0),
    (1, 1280, 16, 8, 256, 1024, 0.0)]


@pytest.mark.parametrize("b,t,h,kv,dh,window,cap", WGMMA_CASES)
def test_flash_bf16_kernel_tiles_and_groups(dev, b, t, h, kv, dh, window,
                                            cap):
    q, k, v = _qkv(dev, b, t, h, kv, dh, torch.bfloat16, seed=3)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, window=window, softcap=cap)
    want = fa.flash_attention_plain(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1}
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _assert_bf16_gates(out, want)


# the decoder prefills of the encoder-decoder and frontend archs:
# seamless-m4t-medium's (dh 64 with a GQA group of 1) and llava-next-34b's
# (2,880 frontend positions and 448 text tokens, a GQA group of 7)
@pytest.mark.parametrize("b,t,h,kv,dh", [(4, 512, 16, 16, 64),
                                         (4, 3328, 56, 8, 128)],
                         ids=["seamless", "llava"])
def test_flash_bf16_encdec_and_frontend_shapes(dev, b, t, h, kv, dh):
    q, k, v = _qkv(dev, b, t, h, kv, dh, torch.bfloat16, seed=t)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1}
    _assert_bf16_gates(out, fa.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_flash_bf16_every_head_dim(dev, dh):
    """Each head dim's panels and swizzle (128, 64 and 32 bytes) on a
    ragged length with a window edge inside a key tile."""
    q, k, v = _qkv(dev, 2, 320, 4, 2, dh, torch.bfloat16, seed=dh)
    out = fa.flash_attention(q, k, v, window=100, softcap=50.0)
    want = fa.flash_attention_plain(q, k, v, window=100, softcap=50.0)
    torch.cuda.synchronize()
    _assert_bf16_gates(out, want)


def test_flash_bf16_kernel_is_deterministic(dev):
    q, k, v = _qkv(dev, 2, 1024, 8, 4, 256, torch.bfloat16, seed=9)
    one = fa.flash_attention(q, k, v, window=300, softcap=50.0)
    two = fa.flash_attention(q, k, v, window=300, softcap=50.0)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


# (b, tq, tk, h, kv, dh, window, softcap, causal): tq > tk + window - 1,
# so query rows qi >= tk + window - 1 see no key and the reference gives
# each the mean of V over all tk keys; tq = 2 tk + 64 puts such rows in a
# CTA of their own and beside rows that do see keys
EMPTY_BAND_CASES = [(1, 256, 128, 2, 1, 32, 64, 0.0, True),
                    (1, 320, 128, 2, 1, 32, 64, 0.0, True),
                    (2, 320, 128, 8, 4, 256, 64, 50.0, True),
                    (1, 320, 128, 2, 1, 32, 64, 0.0, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,kv,dh,window,cap,causal",
                         EMPTY_BAND_CASES)
def test_flash_rows_that_see_no_key(dev, b, tq, tk, h, kv, dh, window, cap,
                                    causal, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(tq + dh)
    q = torch.randn((b, tq, h, dh), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, tk, kv, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1}
    if dtype == torch.bfloat16:
        _assert_bf16_gates(out, want)
    else:
        assert float((out - want).abs().max()) <= 2e-5
    # the empty rows are the mean of V over every key, not 0
    mean_v = v.float().mean(dim=1, keepdim=True).repeat_interleave(h // kv,
                                                                   dim=2)
    tail = out[:, tk + window - 1:].float()
    assert float((tail - mean_v).abs().max()) <= 3e-2


def _shifted(x, elems):
    """A contiguous copy of x whose base lies ``elems`` elements into its
    storage."""
    flat = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    out = flat[elems:].view(x.shape)
    out.copy_(x)
    return out


def test_flash_bf16_refuses_unaligned_base(dev):
    """The bf16 kernel loads by TMA, whose tensor maps need a 16-byte
    aligned base: a contiguous view with an offset is refused, unlaunched."""
    q, k, v = _qkv(dev, 1, 128, 4, 2, 64, torch.bfloat16)
    fa.reset_launches()
    with pytest.raises(ValueError, match="q: base address"):
        fa.flash_attention(_shifted(q, 1), k, v)
    with pytest.raises(ValueError, match="k: base address"):
        fa.flash_attention(q, _shifted(k, 4), v)
    with pytest.raises(ValueError, match="v: base address"):
        fa.flash_attention(q, k, _shifted(v, 2))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    out = fa.flash_attention(q, k, _shifted(v, 8))   # 16 bytes: taken
    _assert_bf16_gates(out, fa.flash_attention_plain(q, k, v))


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 128, 4, 2, 64, torch.float32)
    fa.reset_launches()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="like q"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    with pytest.raises(ValueError, match="h % kv"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="grad"):
        fa.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="CPU or all"):
        fa.flash_attention(q.detach(), k.cpu(), v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0


# ---------------------------------------------------------------------------
# the kernels' public API: hadamard_blocks, lattice_encode, lattice_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,c", [(3, 128, 128), (2, 128, 64),
                                   (7, 16, 16), (2, 256, 128)])
def test_hadamard_kernel_matches_plain_version(dev, n, r, c, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(n * r * c)
    x = torch.randn((n, r, c), generator=g, device=dev).to(dtype)
    hd.reset_launches()
    out = hd.hadamard_blocks(x)
    torch.cuda.synchronize()
    assert hd.LAUNCHES == {"hadamard_blocks": 1}
    assert out.dtype == torch.float32
    assert torch.equal(out, hd.hadamard_plain(x))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", [2762, 25_450, 50_000])
def test_rotate_blocks_equals_fused_rotate(dev, d, inverse):
    g = torch.Generator(device=dev)
    g.manual_seed(d)
    padded = pad_len(d)
    x = torch.randn((padded,), generator=g, device=dev)
    x[d:] = 0
    sg = signs(g, padded)
    assert torch.equal(ops.rotate_blocks(x[:d], sg, inverse=inverse),
                       kx.fused_rotate(x[None], sg, inverse=inverse)[0])


def _lattice(dev, d, bits, seed=0):
    """y straddling 0 at a γ where y/γ spans the ring twice, U(0,1) noise,
    and a reference w within a tenth of γ of y."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    y = torch.randn((d,), generator=g, device=dev)
    u = torch.rand((d,), generator=g, device=dev)
    gamma = float(y.abs().max()) / (1 << bits) / 2
    w = y + 0.1 * gamma * torch.randn((d,), generator=g, device=dev)
    return y, u, w, gamma


@pytest.mark.parametrize("bits", [1, 4, 8, 12, 16])
@pytest.mark.parametrize("d", [1024, 32_768, 1 << 20])
def test_lattice_kernels_match_plain_versions(dev, d, bits):
    y, u, w, gamma = _lattice(dev, d, bits)
    lq.reset_launches()
    codes = lq.lattice_encode(y, u, gamma, bits=bits)
    out = lq.lattice_decode(codes, w, gamma, bits=bits)
    torch.cuda.synchronize()
    assert lq.LAUNCHES == {"lattice_encode": 1, "lattice_decode": 1}
    assert torch.equal(codes, lq.lattice_encode_plain(y, u, gamma, bits=bits))
    assert torch.equal(out, lq.lattice_decode_plain(codes, w, gamma,
                                                    bits=bits))
    assert int(codes.min()) >= 0 and int(codes.max()) < 1 << bits


def test_lattice_unaligned_views_take_the_scalar_path(dev):
    """Views at a 4-byte offset cannot take float4 loads; the scalar pass
    gives the same values."""
    y, u, w, gamma = _lattice(dev, 32_768, 8)
    n = 32_768 - 1024
    codes = lq.lattice_encode(y, u, gamma)
    out = lq.lattice_decode(codes, w, gamma)
    assert torch.equal(lq.lattice_encode(y[1:1 + n], u[1:1 + n], gamma),
                       codes[1:1 + n])
    assert torch.equal(lq.lattice_decode(codes[1:1 + n], w[1:1 + n], gamma),
                       out[1:1 + n])


@pytest.mark.parametrize("shape", [(), (1,)])
def test_lattice_gamma_on_the_device_equals_a_number(dev, shape):
    y, u, w, gamma = _lattice(dev, 32_768, 8, seed=1)
    g_dev = torch.full(shape, gamma, dtype=torch.float32, device=dev)
    codes = lq.lattice_encode(y, u, g_dev)
    assert torch.equal(codes, lq.lattice_encode(y, u, gamma))
    assert torch.equal(lq.lattice_decode(codes, w, g_dev),
                       lq.lattice_decode(codes, w, gamma))


def test_api_wrappers_refuse_what_the_kernels_do_not_take(dev):
    y, u, w, gamma = _lattice(dev, 4096, 8)
    codes = lq.lattice_encode(y, u, gamma)
    hd.reset_launches()
    lq.reset_launches()
    with pytest.raises(ValueError, match="multiple of 1024"):
        lq.lattice_encode(y[:1000], u[:1000], gamma)
    with pytest.raises(ValueError, match="bits"):
        lq.lattice_decode(codes, w, gamma, bits=17)
    with pytest.raises(ValueError, match="codes"):
        lq.lattice_decode(codes.long(), w, gamma)
    with pytest.raises(ValueError, match="CPU or all"):
        lq.lattice_encode(y, u.cpu(), gamma)
    with pytest.raises(ValueError, match="CPU or all"):
        lq.lattice_encode(y, u, torch.tensor(gamma))
    with pytest.raises(ValueError, match="contiguous"):
        lq.lattice_encode(torch.stack((y, y), 1).reshape(-1)[::2], u, gamma)
    with pytest.raises(ValueError, match="power of two"):
        hd.hadamard_blocks(torch.zeros((2, 96, 128), device=dev))
    with pytest.raises(ValueError, match="exceeds"):
        hd.hadamard_blocks(torch.zeros((1, 256, 256), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        hd.hadamard_blocks(torch.zeros((2, 64, 64), device=dev)
                           .transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hd.hadamard_blocks(torch.zeros((2, 64, 64), device=dev).half())
    torch.cuda.synchronize()
    assert hd.LAUNCHES == {"hadamard_blocks": 0}
    assert lq.LAUNCHES == {"lattice_encode": 0, "lattice_decode": 0}


def test_broadcast_decode_of_one_message(dev):
    """QuAFL's per-message downlink: one message with one sign row decoded
    against s client models, as the codec API calls fused_decode."""
    from repro_torch.compression.lattice import LatticeQuantizer
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn((1, 2762), generator=g, device=dev)
    refs = x + 0.01 * torch.randn((16, 2762), generator=g, device=dev)
    q = LatticeQuantizer(bits=8, backend="cuda")
    key = q.keys(g, 1, 2762)
    msg = q.encode(key, x, torch.full((1,), 0.5, device=dev))
    out = q.decode(key, msg, refs)
    want = LatticeQuantizer(bits=8, backend="torch").decode(key, msg, refs)
    assert out.shape == (16, 2762) and torch.equal(out, want)


class _StepLog:
    """A codec recording each message's quantization step (γ, or ‖x‖ over
    the levels for ``scalar``)."""

    def __init__(self, codec, steps):
        self.codec, self.steps = codec, steps

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def encode(self, key, x, hint=None):
        msg = self.codec.encode(key, x, hint)
        div = self.codec.quant.levels if self.codec.name == "scalar" else 1
        self.steps.append(float(msg.gamma.max()) / div)
        return msg


@pytest.mark.parametrize("uplink", ["grouped", "scalar"])
def test_quafl_round_on_the_card_matches_plain_backend(dev, uplink):
    """One QuAFL round at the quickstart's size on the kernels and on the
    plain versions with the same draws: the grouped uplink (a per-message
    levels row) and the per-message branch (a scalar uplink, the lattice
    downlink through the codec API), within the round's largest step."""
    import dataclasses

    from repro_torch.compression.pipeline import round_randomness
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.fed.registry import make_algorithm
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched
    spec = ({"fast": "lattice", "slow": "lattice_packed:bits=4"}
            if uplink == "grouped" else uplink)
    fed = FedConfig(n_clients=16, s=4, local_steps=5, lr=0.3, bits=8,
                    swt=10.0, kernel_backend="cuda")
    part, _ = make_federated_classification(0, 16, d=32, iid=False,
                                            device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    p0 = init_mlp_classifier(g, 32, 64, 10)
    algs = [make_algorithm("quafl", f, loss_fn=mlp_loss_batched,
                           template=p0, batch_size=16, uplink=spec,
                           device=dev)
            for f in (fed, dataclasses.replace(fed, kernel_backend="torch"))]
    draws = {"idx": torch.tensor([0, 3, 7, 12], device=dev),
             "h_steps": torch.tensor([5, 0, 2, 5], device=dev),
             "batch_idx": torch.randint(0, 256, (4, 5, 16), generator=g,
                                        device=dev)}
    steps = []
    if uplink == "grouped":
        draws.update(zip(("signs", "u_cl", "u_srv"),
                         round_randomness(g, 4, algs[0].d)))
        for alg in algs:
            def logged(*a, _inner=alg.pipeline.gammas, **k):
                gam = _inner(*a, **k)
                steps.append(float(gam.max()))
                return gam
            alg.pipeline.gammas = logged
    else:
        draws["key_up"] = algs[0].codec_up.keys(g, 4, algs[0].d)
        draws["key_dn"] = algs[0].codec_down.keys(g, 1, algs[0].d)
        for alg in algs:
            alg.codec_up = _StepLog(alg.codec_up, steps)
            alg.codec_down = _StepLog(alg.codec_down, steps)
    kx.reset_launches()
    (a, ma), (b, mb) = [alg.round(alg.init(p0), part, None, draws=draws)
                        for alg in algs]
    torch.cuda.synchronize()
    assert ma["bits_up"] == mb["bits_up"] and ma["bits_down"] == 32_800
    if uplink == "grouped":
        assert ma["bits_up"] == 131_328 - 2 * 16_384    # ids 0 and 3 slow
        assert kx.LAUNCHES["fused_encode"] == kx.LAUNCHES["uplink"] == \
            kx.LAUNCHES["average"] == 1 and kx.LAUNCHES["snap_codes"] == 0
    else:
        assert ma["bits_up"] == 4 * (2762 * 8 + 32)
        assert kx.LAUNCHES["fused_encode"] == kx.LAUNCHES["fused_decode"] == 1
    diff = max(float((a.server - b.server).abs().max()),
               float((a.clients - b.clients).abs().max()))
    assert diff <= max(steps), (diff, max(steps))


# ---------------------------------------------------------------------------
# adaptive_quafl's wide unpacked widths, SCAFFOLD's decodes, topk_ef
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [10, 11, 12, 16])
@pytest.mark.parametrize("m,d_pad", [(4, 4096), (16, 32_768)])
def test_wide_unpacked_widths_equal_plain_versions(dev, m, d_pad, bits):
    """b = 9-16 ride int32 codes at moduli up to 65,536 (adaptive_quafl's
    pipeline): encode, quantize and both snaps bit-equal."""
    x, sg, u, gam = _inputs(dev, m, d_pad, bits)
    kw = dict(bits=bits)
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True, **kw)
    y_p, codes_p = kx.encode_plain(x, sg, u, gam, want_rotated=True, **kw)
    assert torch.equal(y, y_p) and torch.equal(codes, codes_p)
    assert codes.dtype == torch.int32 and int(codes.max()) < (1 << bits)
    assert int(codes.max()) >= (1 << (bits - 1))   # the codes span the ring
    assert torch.equal(kx.quantize_codes(y, u, gam, **kw), codes)
    ref = _ref_rows(dev, y, gam)
    for c, r, g, _ in _decode_cases(codes, ref, gam):
        assert torch.equal(kx.snap_codes(c, r, g, **kw),
                           kx.snap_plain(c, r, g, **kw))


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_decode_of_s_messages_against_s_references(dev, bits):
    """SCAFFOLD's control messages: s codes, each with its own sign row,
    decoded against s distinct references (each client's previous c_i)."""
    x, sg, u, gam, codes, ref = _decode_case(dev, 16, 32_768, bits, 1,
                                             sign_rows=True)
    assert torch.equal(codes, kx.encode_plain(x, sg, u, gam, bits=bits))
    out = kx.fused_decode(codes, ref, sg, gam, bits=bits)
    assert torch.equal(out, kx.decode_plain(codes, ref, sg, gam, bits=bits))


@pytest.mark.parametrize("d,frac", [(2762, 0.01), (25_450, 0.01),
                                    (4096, 0.25)])
def test_topk_ef_on_the_card_equals_the_cpu(dev, d, frac):
    """Three threaded ``topk_ef`` calls on messages full of ties: the card
    picks the CPU's index sets and values, its residuals are bit-equal, and
    decoded + new residual == delta + old residual bit for bit."""
    from repro_torch.compression.codecs import TopKEFCodec
    codec = TopKEFCodec(frac=frac)
    g = torch.Generator(device=dev)
    g.manual_seed(d)
    m = 16
    state = torch.zeros((m, d), device=dev)
    state_c = state.cpu()
    zero = torch.zeros((1, d), device=dev)
    for _ in range(3):
        x = torch.randint(-3, 4, (m, d), generator=g, device=dev) * 0.25
        x[torch.rand((m, d), generator=g, device=dev) < 0.33] = 0.0
        msg, new = codec.encode_stateful(None, x, None, state)
        msg_c, new_c = codec.encode_stateful(None, x.cpu(), None, state_c)
        idx, order = torch.sort(msg.idx.cpu(), dim=1)
        idx_c, order_c = torch.sort(msg_c.idx, dim=1)
        assert torch.equal(idx, idx_c)
        assert torch.equal(torch.gather(msg.vals.cpu(), 1, order),
                           torch.gather(msg_c.vals, 1, order_c))
        assert torch.equal(new.cpu(), new_c)
        dec = codec.decode(None, msg, zero)
        assert torch.equal(dec + new, x + state)
        state, state_c = new, new_c


# ---------------------------------------------------------------------------
# the round engine: chunks captured as CUDA graphs and replayed
# ---------------------------------------------------------------------------

def _engine_world(dev, n=8, s=4, name="quafl", **kw):
    """A small federated world on the card: n clients of an MLP 16-32-4,
    the kernels' backend, and the named algorithm."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.fed import make_algorithm
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched
    fed = FedConfig(n_clients=n, s=s, local_steps=2, lr=0.3, bits=8,
                    kernel_backend="cuda")
    part, _ = make_federated_classification(0, n, d=16, n_classes=4,
                                            iid=True, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    p0 = init_mlp_classifier(g, 16, 32, 4)
    alg = make_algorithm(name, fed, loss_fn=mlp_loss_batched, template=p0,
                         batch_size=8, device=dev, **kw)
    return alg, p0, part


@pytest.mark.parametrize("name,kw", [
    ("quafl", {}), ("quafl", {"uplink": "lattice_packed:bits=4"}),
    ("fedbuff_device", {"buffer_size": 3, "quantize": True,
                        "quantizer": "lattice"})])
def test_captured_chunks_equal_eager_rounds(dev, name, kw):
    """scan_chunk=2 over 5 rounds (chunks 2, 2, 1, each captured once as a
    CUDA graph, the first replayed twice) against the eager loop from the
    same generator state: every row exact, the final server within the
    reference's lattice-chunk tolerance (exact in practice), the generator
    left where the eager run leaves it, and the kernels run by the graph
    (the Python launch counters see only the captured rounds)."""
    from repro_torch.fed import simulate
    from repro_torch.utils.tree import tree_flatten_vector
    alg, p0, part = _engine_world(dev, name=name, **kw)

    def run(chunk):
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        kx.reset_launches()
        tr = simulate(alg, p0, part, g, rounds=5, eval_every=0,
                      record_every=1, scan_chunk=chunk)
        torch.cuda.synchronize()
        return tr, g, dict(kx.LAUNCHES)

    (tre, ge, le), (trs, gs, ls) = run(0), run(2)
    assert tre.engine == "eager" and trs.engine == "scanned"
    for a, b in zip(tre.rows, trs.rows):
        assert {k: v for k, v in a.items() if k != "wall_time_s"} == \
            {k: v for k, v in b.items() if k != "wall_time_s"}
    fe = tree_flatten_vector(alg.eval_params(tre.final_state))
    fs = tree_flatten_vector(alg.eval_params(trs.final_state))
    torch.testing.assert_close(fs, fe, rtol=1e-4, atol=5e-7)
    assert torch.equal(ge.get_state(), gs.get_state())
    per_round = {k: v // 5 for k, v in le.items()}
    assert all(v % 5 == 0 for v in le.values()) and any(per_round.values())
    # captured: two graphs (lengths 2 and 1) saw 3 rounds of launches, on
    # top of one warm-up round each
    assert ls == {k: 5 * v for k, v in per_round.items()}
    # a second run replays both graphs: no launch from Python at all
    _, _, again = run(2)
    assert not any(again.values()), again


def test_a_chunk_that_syncs_raises_under_capture(dev):
    """A round that reads a value on the host cannot be captured: its
    chunk on the card raises instead of running eagerly, and an eager run
    still works. (Floyd's sampler, above 4,096 clients, no longer reads
    its draws on the host: its chunk captures, next test.)"""
    from repro_torch.fed import RoundEngine
    alg, p0, part = _engine_world(dev, n=8, s=2)
    inner = alg.device_round

    def syncing_round(state, data, generator):
        float(state.sim_time)          # a host read inside the round
        return inner(state, data, generator)

    alg.device_round = syncing_round
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        RoundEngine(alg).run_chunk(alg.init(p0), part, g, 2)
    state, m = alg.round(alg.init(p0), part, g)
    assert float(m["sim_time"]) == alg.fed.swt + alg.fed.sit


def test_no_cycle_is_collected_inside_a_capture(dev):
    """The cyclic collector is off while a chunk is captured (a dead
    graph it frees there would be destroyed inside the capture and
    invalidate it), on for the warm-up round, and on again after, also
    when the capture fails."""
    import gc
    from repro_torch.fed import RoundEngine
    alg, p0, part = _engine_world(dev, n=8, s=2)
    inner, seen = alg.device_round, []

    def watched_round(state, data, generator):
        seen.append(gc.isenabled())
        return inner(state, data, generator)

    alg.device_round = watched_round
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    RoundEngine(alg).run_chunk(alg.init(p0), part, g, 2)
    assert seen == [True, False, False] and gc.isenabled()

    def syncing_round(state, data, generator):
        seen.append(gc.isenabled())
        float(state.sim_time)
        return inner(state, data, generator)

    alg.device_round, seen[:] = syncing_round, []
    with pytest.raises(RuntimeError, match="stream is capturing"):
        RoundEngine(alg).run_chunk(alg.init(p0), part, g, 2)
    assert seen == [True, False] and gc.isenabled()


def test_floyd_sampler_captures_and_equals_eager(dev):
    """Above 4,096 clients the uniform sampler is Floyd's, its draws and
    its duplicate test on the device: a captured chunk of it draws the
    eager rounds' cohorts, bits and sim_time exactly."""
    from repro_torch.fed import simulate
    from repro_torch.utils.tree import tree_flatten_vector
    out = {}
    for chunk in (0, 2):
        alg, p0, part = _engine_world(dev, n=4200, s=2)
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        tr = simulate(alg, p0, part, g, rounds=4, eval_every=0,
                      record_every=1, scan_chunk=chunk)
        out[chunk] = (tr, tree_flatten_vector(alg.eval_params(
            tr.final_state)), g.get_state())
    assert out[2][0].engine == "scanned"
    assert [(r["bits_up"], r["sim_time"]) for r in out[0][0].rows] == \
        [(r["bits_up"], r["sim_time"]) for r in out[2][0].rows]
    torch.testing.assert_close(out[2][1], out[0][1], rtol=1e-4, atol=5e-7)
    assert torch.equal(out[0][2], out[2][2])


def test_captured_chunk_spans_time_its_phases(dev):
    """The paper's MLP at the benchmark cell's size (784-32-10, n 300, s 16,
    K 5, batch 32), three 10-round chunks captured with spans on
    (``utils/spans``): the five phases cover at least 95% of every
    ``quafl.round``'s device interval, the rounds at least 95% of every
    ``engine.replay``'s, the counters hold every round, and the state,
    bits and generator equal the chunks captured without spans."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.fed import RoundEngine, make_algorithm
    from repro_torch.fed.engine import _leaves, clone_tree
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched
    from repro_torch.utils import spans
    fed = FedConfig(n_clients=300, s=16, local_steps=5, lr=0.3, bits=8,
                    kernel_backend="cuda")
    part, _ = make_federated_classification(0, 300, d=784, n_classes=10,
                                            iid=False, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    p0 = init_mlp_classifier(g, 784, 32, 10)
    alg = make_algorithm("quafl", fed, loss_fn=mlp_loss_batched,
                         template=p0, batch_size=32, device=dev)
    eng, state0 = RoundEngine(alg), alg.init(p0)
    out = {}
    for on in (False, True):
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        st = clone_tree(state0)
        with (spans.recording() if on else contextlib.nullcontext()) as log:
            for _ in range(3):
                st, _ = eng.run_chunk(st, part, gen, 10)
        torch.cuda.synchronize()
        out[on] = ([x.clone() if isinstance(x, torch.Tensor) else x
                    for x in _leaves(st)], gen.get_state())
    for x, y in zip(out[False][0], out[True][0]):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert torch.equal(out[False][1], out[True][1])
    assert eng.chunk_programs() == {10: 1} and len(eng._graphs) == 2
    summ = log.summary()
    recs = log.records
    kids = {}
    for r in recs:
        if r.parent is not None:
            kids.setdefault(r.parent, []).append(r)
    rounds = [i for i, r in enumerate(recs) if r.name == "quafl.round"]
    replays = [i for i, r in enumerate(recs) if r.name == "engine.replay"]
    assert len(rounds) == 30 and len(replays) == 3 and log.rounds == 30
    for i in rounds:
        names = [k.name for k in kids[i]]
        assert names == ["quafl.cohort", "quafl.local", "quafl.progress",
                         "quafl.exchange", "quafl.commit"]
        assert sum(k.device_ms for k in kids[i]) >= 0.95 * recs[i].device_ms
    for i in replays:
        assert [k.name for k in kids[i]] == ["quafl.round"] * 10
        assert sum(k.device_ms for k in kids[i]) >= 0.95 * recs[i].device_ms
    # the nested spans are left out of a captured chunk; the capture's
    # set-up is noted from the host times graph_times keeps
    assert set(summ["spans"]) == {"engine.replay", "quafl.round",
                                  "quafl.cohort", "quafl.local",
                                  "quafl.progress", "quafl.exchange",
                                  "quafl.commit", "engine.warmup",
                                  "engine.capture", "engine.instantiate"}
    captured = [g.times for key, g in eng._graphs.items() if key[2]]
    assert summ["spans"]["engine.capture"]["host_ms"] == \
        captured[0]["capture_ms"]
    assert summ["counters"]["local.steps_computed"] == 30 * 16 * 5
    assert 0 < summ["counters"]["local.steps_active"] <= 30 * 16 * 5


# ---------------------------------------------------------------------------
# federated LM training (launch/train.py) on the card
# ---------------------------------------------------------------------------

LM_ARGV = ["--arch", "llama3.2-1b", "--reduced", "--batch", "4", "--seq",
           "64", "--log-every", "1", "--lr", "0.05", "--steps", "3",
           "--algo", "quafl"]


def test_lm_quafl_round_on_cuda_equals_torch_round(dev):
    """One reduced-width QuAFL round of llama3.2-1b on the CUDA kernels
    against the same round on their plain versions, from copies of one
    generator (the same draws): bits equal, and the server and clients
    within one lattice step (the round's largest γ: a code may flip at a
    rounding boundary; the codes are otherwise exact)."""
    from functools import partial

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synthetic import federated_token_task
    from repro_torch.fed import make_algorithm
    from repro_torch.launch.train import shape_template
    from repro_torch.models.model import init_lm, lm_loss
    cfg = get_reduced("llama3.2-1b")
    data, batch_fn = federated_token_task(0, 2, 16, 4, 64, cfg.vocab_size,
                                          device=dev)
    out = {}
    for backend in ("cuda", "torch"):
        p0, _ = init_lm(cfg, seed=0, device=dev)
        fed = FedConfig(n_clients=2, s=2, local_steps=2, lr=0.05,
                        kernel_backend=backend)
        alg = make_algorithm("quafl", fed, loss_fn=partial(lm_loss, cfg),
                             template=shape_template(p0), batch_fn=batch_fn,
                             batch_size=4, device=dev)
        gammas = []
        enc = alg.pipeline.rotate_encode

        def rotate_encode(x2, sg, u2, gam, _enc=enc, _log=gammas, **kw):
            _log.append(float(gam.max()))
            return _enc(x2, sg, u2, gam, **kw)

        quant = alg.pipeline.quantize

        def quantize(y2, u2, gam, wire=None, _q=quant, _log=gammas):
            _log.append(float(gam.max()))
            return _q(y2, u2, gam, wire)

        alg.pipeline.rotate_encode = rotate_encode
        alg.pipeline.quantize = quantize
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        state, m = alg.round(alg.init(p0), data, g)
        out[backend] = (state, m, max(gammas))
    (sc, mc, step), (sp, mp, _) = out["cuda"], out["torch"]
    assert mc["bits_up"] == mp["bits_up"] and mc["bits"] == mp["bits"]
    for a, b in ((sc.server, sp.server), (sc.clients, sp.clients)):
        assert float((a - b).abs().max()) <= step


ZOO = ["gemma3-12b", "mamba2-370m", "llama4-scout-17b-a16e",
       "deepseek-v2-236b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_prefill_and_decode_on_the_card_match_the_cpu(dev, arch):
    """The reduced arch in fp32 on the card (the fp32 flash kernel in the
    attention layers at t = 128; the Mamba, MoE and MLA blocks in plain
    PyTorch) against the same weights and tokens on the CPU: logits of a
    prefill into a cache and of four decode steps within 1e-4 of
    max|logit|, the caches within 1e-4 of their largest value, and the
    aux loss within 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import decode_step, forward, init_cache
    from repro_torch.models.model import init_lm
    cfg = get_reduced(arch)
    p, _ = init_lm(cfg, seed=0, device="cpu")
    g = torch.Generator()
    g.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 132), generator=g)
    out = {}
    for d in ("cpu", dev):
        pd = {k: v.to(d) for k, v in p.items()}
        cache = init_cache(cfg, 2, 136, d)
        lg, cache, aux = forward(cfg, pd, {"tokens": toks[:, :128].to(d)},
                                 cache=cache)
        logits = [lg.cpu()]
        for i in range(4):
            lg, cache = decode_step(cfg, pd, toks[:, 128 + i:129 + i].to(d),
                                    128 + i, cache)
            logits.append(lg.cpu())
        out[str(d)] = (logits, {k: v.cpu() for k, v in cache.items()},
                       float(aux))
    (lc, cc, ac), (lg_, cg, ag) = out["cpu"], out[str(dev)]
    for a, b in zip(lg_, lc):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for k in cc:
        scale = max(float(cc[k].float().abs().max()), 1e-30)
        assert float((cg[k].float() - cc[k].float()).abs().max()) <= \
            1e-4 * scale, k
    assert abs(ag - ac) <= 1e-5


def test_zoo_lm_loss_gradient_on_the_card_matches_the_cpu(dev):
    """ce + aux of reduced jamba (Mamba, attention and MoE layers) and its
    gradient on the card against the CPU: within 1e-4 of the largest
    gradient."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_lm, lm_loss
    cfg = get_reduced("jamba-1.5-large-398b")
    p, _ = init_lm(cfg, seed=1, device="cpu")
    g = torch.Generator()
    g.manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    grads = {}
    for d in ("cpu", dev):
        leaves = {k: v.to(d).requires_grad_(True) for k, v in p.items()}
        loss, _ = lm_loss(cfg, leaves, {"tokens": toks.to(d)})
        keys = sorted(leaves)
        gr = torch.autograd.grad(loss, [leaves[k] for k in keys])
        grads[str(d)] = (float(loss.detach()),
                         {k: v.cpu() for k, v in zip(keys, gr)})
    (lc, gc), (lg_, gg) = grads["cpu"], grads[str(dev)]
    assert abs(lg_ - lc) <= 1e-5 * abs(lc)
    scale = max(float(v.abs().max()) for v in gc.values())
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-4 * scale, k


def test_lm_scan_chunk_run_equals_eager_run(dev):
    """``--scan-chunk 2`` (chunks captured as CUDA graphs) against the
    eager run of the same reduced LM: rows and the server bit-equal."""
    from repro_torch.launch import train
    eager = train.main(LM_ARGV + ["--steps", "4"])
    chunked = train.main(LM_ARGV + ["--steps", "4", "--scan-chunk", "2"])
    assert chunked.trace.engine == "scanned"
    for a, b in zip(eager.trace.rows, chunked.trace.rows):
        for k in ("bits_up", "bits_down", "sim_time", "quant_err",
                  "server_loss"):
            assert a[k] == b[k], (k, a, b)
    assert torch.equal(eager.trace.final_state.server,
                       chunked.trace.final_state.server)


def test_int8_sign_draws_equal_int64_on_the_card(dev):
    g1, g2 = torch.Generator(device=dev), torch.Generator(device=dev)
    g1.manual_seed(5)
    g2.manual_seed(5)
    n = 1_000_003
    want = (torch.randint(0, 2, (n,), generator=g2, device=dev) * 2
            - 1).to(torch.float32)
    assert torch.equal(signs(g1, n), want)
    assert torch.equal(torch.rand(7, generator=g1, device=dev),
                       torch.rand(7, generator=g2, device=dev))


# ---------------------------------------------------------------------------
# the mesh train step (spmd) over an NCCL process group of one rank
# ---------------------------------------------------------------------------

SPMD_TRANSPORTS = ("dequant_psum", "code_allgather", "shard_local",
                   "shard_local_codes", "shard_local_rs")


@pytest.fixture(scope="module")
def nccl_mesh():
    """The (1, 1) mesh over an NCCL group of one rank (an in-memory store,
    no port), made once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield make_mesh((1, 1), ("data", "model"))
    dist.destroy_process_group()


def _spmd(dev, mesh, transport):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synthetic import federated_token_task
    from repro_torch.fed import make_algorithm
    from repro_torch.models.model import init_lm
    cfg = get_reduced("llama3.2-1b")
    p0, _ = init_lm(cfg, seed=0, device=dev)
    fed = FedConfig(n_clients=1, s=1, local_steps=2, lr=0.05, bits=8,
                    transport=transport)
    alg = make_algorithm("spmd", fed, loss_fn=None, template=p0, cfg=cfg,
                         mesh=mesh, batch=2, seq=32, device=dev)
    data, _ = federated_token_task(0, 1, 16, 2, 32, cfg.vocab_size,
                                   device=dev)
    return alg, p0, data


def _train_equal(a, b) -> bool:
    return all(torch.equal(a.server[k], b.server[k])
               and torch.equal(a.clients[k], b.clients[k]) for k in a.server)


@pytest.mark.parametrize("transport", SPMD_TRANSPORTS)
def test_spmd_nccl_group_of_one_equals_local_mesh(dev, nccl_mesh, transport):
    """Every collective through NCCL at one rank changes nothing: servers,
    clients and metrics bit-equal to the local mesh's, the kernels
    launched on both."""
    from repro_torch.launch.mesh import Mesh
    out = []
    for mesh in (Mesh((1, 1), ("data", "model")), nccl_mesh):
        alg, p0, data = _spmd(dev, mesh, transport)
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        st, ms = alg.init(p0), []
        kx.reset_launches()
        for _ in range(2):
            st, m = alg.round(st, data, g)
            ms.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        out.append((st.train, ms, dict(kx.LAUNCHES)))
    assert _train_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] and out[0][2] == out[1][2]
    assert out[1][2]["fused_encode"] == 2 * 2 * 11


@pytest.mark.parametrize("transport", ["dequant_psum", "shard_local_rs"])
def test_spmd_captured_chunks_equal_eager(dev, nccl_mesh, transport):
    """scan_chunk=2 on the NCCL mesh (the collectives captured in the
    chunk's graph) against the eager loop: rows and state bit for bit."""
    from repro_torch.fed import simulate
    traces = {}
    for chunk in (0, 2):
        alg, p0, data = _spmd(dev, nccl_mesh, transport)
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        traces[chunk] = simulate(alg, p0, data, g, rounds=4, eval_every=0,
                                 record_every=1, scan_chunk=chunk)
    assert traces[2].engine == "scanned"
    for a, b in zip(traces[0].rows, traces[2].rows):
        assert {k: v for k, v in a.items() if k != "wall_time_s"} == \
            {k: v for k, v in b.items() if k != "wall_time_s"}
    assert _train_equal(traces[0].final_state.train,
                        traces[2].final_state.train)


# ---------------------------------------------------------------------------
# the split population store and the mesh serving steps on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("quafl", {}), ("quafl_scaffold", {}),
    ("fedbuff_device", {"buffer_size": 3, "quantize": True,
                        "quantizer": "lattice"})])
def test_split_store_nccl_group_of_one_equals_whole_store(dev, nccl_mesh,
                                                          name, kw):
    """The store split over client_mesh() on the NCCL group of one, run as
    one captured chunk of 4 rounds (its all-gathers inside the graph),
    equals the same chunk on the whole store: bits, sim_time, server and
    every row bit for bit; the kernels launched on both."""
    from repro_torch.fed import (SplitRow, client_mesh, simulate,
                                 whole_row)
    from repro_torch.utils.tree import tree_flatten_vector
    out = []
    for cm in (None, client_mesh()):
        extra = dict(kw, client_mesh=cm) if cm is not None else kw
        alg, p0, part = _engine_world(dev, name=name, **extra)
        g = torch.Generator(device=dev)
        g.manual_seed(2)
        kx.reset_launches()
        tr = simulate(alg, p0, part, g, rounds=4, eval_every=0,
                      record_every=1, scan_chunk=4)
        torch.cuda.synchronize()
        st = tr.final_state
        pop = (st.base if hasattr(st, "base") else st).pop
        out.append((tr, tree_flatten_vector(alg.eval_params(st)),
                    {k: whole_row(v) for k, v in pop.rows.items()
                     if not isinstance(v, tuple)},
                    [k for k, v in pop.rows.items()
                     if isinstance(v, SplitRow)], dict(kx.LAUNCHES)))
    (tw, sw, rw, _, lw), (ts, ss, rs, split, ls) = out
    assert tw.engine == ts.engine == "scanned"
    assert "group" in split and len(split) >= 2
    assert [(r["bits_up"], r["bits_down"], r["sim_time"])
            for r in tw.rows] == [(r["bits_up"], r["bits_down"],
                                   r["sim_time"]) for r in ts.rows]
    assert torch.equal(ss, sw)
    assert all(torch.equal(rs[k], v) for k, v in rw.items())
    assert lw == ls and (ls["fused_encode"] or ls["fused_decode"])


def test_mesh_prefill_step_launches_flash(dev, nccl_mesh):
    """build_prefill_step and build_serve_step at reduced gemma2-2b on the
    NCCL group of one: one flash launch a layer in the prefill (t = 128),
    the logits and 4 greedy tokens equal to ServeEngine's."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, rank_blocks)
    from repro_torch.models.model import init_lm
    from repro_torch.serving import Request, ServeEngine
    cfg = get_reduced("gemma2-2b")
    params, _ = init_lm(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    toks = torch.randint(1, cfg.vocab_size, (2, 128), generator=g,
                         device=dev)
    prefill, _, (p_specs, b_specs) = build_prefill_step(
        cfg, nccl_mesh, ShapeConfig("p", 256, 2, "prefill"))
    step, _, _, _ = build_serve_step(cfg, nccl_mesh,
                                     ShapeConfig("d", 256, 2, "decode"))
    pb = rank_blocks(params, p_specs, nccl_mesh)
    fa.reset_launches()
    logits, cache = prefill(pb, rank_blocks({"tokens": toks}, b_specs,
                                            nccl_mesh))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    got = [tok]
    for i in range(4):
        tok, cache = step(pb, cache, tok, 128 + i)
        got.append(tok)
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=256)
    seen = []
    for row in toks.tolist():
        eng.submit(Request(prompt=row, max_new_tokens=5))
    done = eng.run(on_step=lambda i, lg: seen.append(lg.clone())
                   if i == 0 else None)
    assert torch.equal(logits, seen[0])
    assert torch.cat(got, 1).tolist() == [r.out_tokens for r in done]


def test_meta_branch_takes_meta_only_and_the_walker_counts_launches(dev):
    """A mix of CUDA and ``meta`` tensors raises; CUDA tensors launch the
    kernel, which the cost walker counts once, as the meta branch does
    (``launch/hlocost.py``)."""
    from repro_torch.launch.hlocost import CostWalker
    x, sg, u, gam = _inputs(dev, 4, 4096, 8)
    with pytest.raises(ValueError, match="meta tensors only together"):
        kx.fused_rotate(x, torch.empty(4096, device="meta"))
    q = torch.randn((2, 256, 4, 64), device=dev, dtype=torch.bfloat16)
    k = torch.randn((2, 256, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="meta tensors only together"):
        fa.flash_attention(q, k.to("meta"), k)
    kx.reset_launches()
    fa.reset_launches()
    walks = {}
    for name, args in (("cuda", (x, sg, q, k)),
                       ("meta", tuple(t.to("meta") for t in (x, sg, q, k)))):
        w = CostWalker()
        with w:
            kx.fused_rotate(*args[:2])
            fa.flash_attention(args[2], args[3], args[3], window=64)
        walks[name] = w
    torch.cuda.synchronize()
    assert kx.LAUNCHES["fused_rotate"] == 1
    assert fa.LAUNCHES["flash_attention"] == 1
    for w in walks.values():
        assert w.kernels == {"fused_rotate": 1, "flash_attention": 1}
    assert walks["cuda"].flops == walks["meta"].flops > 0
    assert walks["cuda"].bytes == walks["meta"].bytes > 0


# ---------------------------------------------------------------------------
# the MoE's grouped product: fwd, dgrad and wgrad against their plain
# versions (fp32 max|Δ| <= 1e-5·max|want|, bf16 ‖Δ‖/‖want‖ <= 1e-3: w
# truncated to bf16 rather than rounded to nearest-even is ~4.7e-3 off)
# ---------------------------------------------------------------------------

GROUPED_CASES = {
    # (group sizes, K, N): ragged with empty groups (the first and last
    # among them), all rows in one group, below one 64-row tile, rows past
    # the last group, edges that are not multiples of 64
    "ragged": ([0, 130, 7, 0, 64, 1, 300, 0], 256, 192),
    "one_group": ([0, 0, 517, 0], 128, 64),
    "below_a_tile": ([3, 0, 2], 64, 128),
    "tail_rows": ([40, 0, 25], 200, 136),
    # the bf16 kernels' paths (rows_plan): one group of 600 rows over three
    # 256-row tiles, the last of which begins mid-group and runs into the
    # next group's rows and past R; a decode step's few rows over a long
    # reduction, which splits K (fwd 8 slices, dgrad 2)
    "wide_group": ([0, 600, 40, 0], 128, 136),
    "decode_split": ([0, 2, 1, 0, 3], 4096, 1024),
    # rows past the last group hold NaN in x and dy: the row boxes of both
    # groups run into them (wgrad's stages of 64 rows, fwd's and dgrad's
    # row tiles), which must add exactly nothing; two N tiles of wgrad, the
    # second 8 wide, and a K tile whose second half lies past K
    "nan_outside": ([0, 70, 0, 5], 136, 264),
}
# rows past offs[-1]
GROUPED_TAILS = {"tail_rows": 11, "nan_outside": 57}


def _grouped_inputs(dev, sizes, k, n, dtype, w_dtype=torch.float32,
                    tail=0, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rows = sum(sizes) + tail
    x = torch.randn((rows, k), generator=g, device=dev).to(dtype)
    w = torch.randn((len(sizes), k, n), generator=g, device=dev).to(w_dtype)
    dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    offs = torch.tensor(sizes, device=dev).cumsum(0).to(torch.int32)
    return x, w, dy, offs


def _grouped_gate(got, want, dtype):
    """The fp32 gate where the compute dtype and the output's are fp32;
    the bf16 gate where either is bf16 (dW of a bf16 product stored in
    fp32, or of an fp32 product stored in bf16, is rounded to bf16 on
    either side, and the sums' order may flip a rounding)."""
    lossy = torch.bfloat16 in (dtype, got.dtype)
    got, want = got.float(), want.float()
    if not lossy:
        return float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    return float((got - want).norm()) <= 1e-3 * float(want.norm())


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_mm_kernels_match_plain_versions(dev, case, dtype, w_dtype):
    sizes, k, n = GROUPED_CASES[case]
    tail = GROUPED_TAILS.get(case, 0)
    x, w, dy, offs = _grouped_inputs(dev, sizes, k, n, dtype, w_dtype, tail)
    if case == "nan_outside":
        x[sum(sizes):] = float("nan")
        dy[sum(sizes):] = float("nan")
    gm.reset_launches()
    y = gm.grouped_mm_fwd(x, w, offs)
    dx = gm.grouped_mm_dgrad(dy, w, offs)
    dw = gm.grouped_mm_wgrad(x, dy, offs, w_dtype=w_dtype)
    torch.cuda.synchronize()
    assert gm.LAUNCHES == {"grouped_mm_fwd": 1, "grouped_mm_dgrad": 1,
                           "grouped_mm_wgrad": 1}
    assert (y.dtype, dx.dtype, dw.dtype) == (dtype, dtype, w_dtype)
    for got, want, what in (
            (y, gm.grouped_mm_plain(x, w, offs), "fwd"),
            (dx, gm.grouped_mm_dgrad_plain(dy, w, offs), "dgrad"),
            (dw, gm.grouped_mm_wgrad_plain(x, dy, offs, w_dtype=w_dtype),
             "wgrad")):
        assert _grouped_gate(got, want, dtype), (what, case)
    empty = [i for i, s in enumerate(sizes) if s == 0]
    assert not dw[empty].any() and not y[sum(sizes):].any() \
        and not dx[sum(sizes):].any()


def test_grouped_mm_reruns_are_bit_identical(dev):
    """Three runs equal bit for bit, also where the bf16 kernels split K
    (``decode_split``: the slices' partials added in a fixed order)."""
    for case in ("ragged", "decode_split"):
        sizes, k, n = GROUPED_CASES[case]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy, offs = _grouped_inputs(dev, sizes, k, n, dtype)
            runs = [(gm.grouped_mm_fwd(x, w, offs),
                     gm.grouped_mm_dgrad(dy, w, offs),
                     gm.grouped_mm_wgrad(x, dy, offs, w_dtype=w.dtype))
                    for _ in range(3)]
            for run in runs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
    sms = gm.sm_count(torch.cuda.current_device())
    assert gm.rows_plan(6, 5, 4096, 1024, sms).splits > 1
    assert gm.rows_plan(6, 5, 1024, 4096, sms).splits > 1


def test_grouped_mm_captured_forward_backward_equals_eager(dev):
    """``grouped_mm`` forward and backward captured in a CUDA graph and
    replayed equal the eager run bit for bit (offsets read on the card),
    also where the bf16 kernels split K (the workspace of the partials is
    captured with the graph)."""
    for case in ("ragged", "decode_split"):
        sizes, k, n = GROUPED_CASES[case]
        x, w, dy, offs = _grouped_inputs(dev, sizes, k, n, torch.bfloat16)
        x.requires_grad_()
        w.requires_grad_()

        def step():
            # y detached: a graph kept alive would keep the leaves' gradient
            # accumulators of the eager run's stream into the capture
            y = gm.grouped_mm(x, w, offs)
            return (y.detach(), *torch.autograd.grad(y, (x, w), dy))

        eager = step()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = step()
        gm.reset_launches()
        graph.replay()
        torch.cuda.synchronize()
        assert gm.LAUNCHES == {k: 0 for k in gm.LAUNCHES}  # a replay: no call
        assert all(torch.equal(a, b) for a, b in zip(eager, captured))
        # new offsets in place: the replay follows them
        offs.copy_(torch.tensor(sizes[::-1], device=dev).cumsum(0).to(
            torch.int32))
        graph.replay()
        want = step()
        assert all(torch.equal(a, b) for a, b in zip(want, captured))


@pytest.mark.parametrize("what", ["x", "dy", "w"])
def test_grouped_mm_refuses_views_that_tma_cannot_read(dev, what):
    """The bf16 kernels read rows and weights with TMA: a contiguous view
    whose base address is not 16-byte aligned is refused, not misread."""
    sizes, k, n = GROUPED_CASES["tail_rows"]
    x, w, dy, offs = _grouped_inputs(dev, sizes, k, n, torch.bfloat16)
    src = {"x": x, "dy": dy, "w": w}[what]
    flat = torch.empty(src.numel() + 1, dtype=src.dtype, device=dev)
    view = flat[1:].view(src.shape)
    view.copy_(src)
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        if what == "x":
            gm.grouped_mm_fwd(view, w, offs)
        elif what == "dy":
            gm.grouped_mm_dgrad(view, w, offs)
        else:
            gm.grouped_mm_fwd(x, view, offs)
    assert gm.grouped_mm_fwd(x, w, offs).shape == (x.shape[0], n)
