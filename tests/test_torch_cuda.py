"""The CUDA kernels on the card: each against its plain version, the launch
counters, and the wrappers' refusals. Needs a CUDA device and nvcc, and
skips without them. The card's machine has no JAX, so run this file there
without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.compression.rotation import pad_len, signs
from repro_torch.kernels import exchange as kx
from repro_torch.kernels import flash_attention as fa
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
    kx.rotate_plain(x, sg)
    kx.decode_plain(codes, x, sg, gam)
    torch.cuda.synchronize()
    assert kx.LAUNCHES == {"fused_encode": 1, "fused_rotate": 1,
                           "quantize_codes": 1, "snap_codes": 1,
                           "fused_decode": 1}


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
# window edges that cross a 64-key tile, GQA groups 1, 2, 4 and 8
WGMMA_CASES = [(2, 200, 8, 4, 256, 0, 50.0), (1, 320, 8, 4, 256, 0, 50.0),
               (2, 320, 8, 4, 256, 100, 50.0), (1, 512, 8, 4, 256, 160, 50.0),
               (1, 320, 4, 2, 128, 37, 30.0)] + [
    (2, 256, 8, kv, 128, 0, 50.0) for kv in (8, 4, 2, 1)]


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
        assert kx.LAUNCHES["fused_encode"] == kx.LAUNCHES["snap_codes"] // 2
    else:
        assert ma["bits_up"] == 4 * (2762 * 8 + 32)
        assert kx.LAUNCHES["fused_encode"] == kx.LAUNCHES["fused_decode"] == 1
    diff = max(float((a.server - b.server).abs().max()),
               float((a.clients - b.clients).abs().max()))
    assert diff <= max(steps), (diff, max(steps))
