"""The CUDA kernels on the card: each against its plain version, the launch
counters, and the wrappers' refusals. Needs a CUDA device and nvcc, and
skips without them. The card's machine has no JAX, so run this file there
without the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.compression.rotation import signs
from repro_torch.kernels import exchange as kx

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


def test_each_wrapper_counts_its_launches(dev):
    x, sg, u, gam = _inputs(dev, 2, 4096, 8)
    kx.reset_launches()
    y, codes = kx.fused_encode(x, sg, u, gam, want_rotated=True)
    kx.fused_rotate(y, sg, inverse=True)
    kx.quantize_codes(y, u, gam)
    kx.snap_codes(codes, y, gam)
    kx.rotate_plain(x, sg)
    torch.cuda.synchronize()
    assert kx.LAUNCHES == {"fused_encode": 1, "fused_rotate": 1,
                           "quantize_codes": 1, "snap_codes": 1}


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
