"""The kernels' public API (``repro_torch.kernels.ops`` and the hadamard and
lattice_quant modules behind it) against ``repro.kernels`` on the CPU: the
reference's Pallas kernels in interpret mode, its jnp oracles
(``kernels/ref.py``) and ``repro.compression.rotation.rotate``. On CPU
tensors every wrapper runs its plain version.

Tolerances: the Hadamard transforms within 1e-5·max|out| (the port runs a
butterfly, the reference two matmuls: same function, other rounding; a
bf16 input is widened exactly on both sides, so it is held to the same);
codes exactly equal and decodes bit-equal (the same fp32 formula on the
same inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import gauss, npy, tt, uniform
from repro.compression.rotation import _signs, rotate as ref_rotate
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.compression.rotation import pad_len
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hadamard as hd
from repro_torch.kernels import lattice_quant as lq
from repro_torch.kernels import ops

ROT_TOL = 1e-5       # max |Δ| / max |out|
LATTICE_CASES = [(1024, 4), (8192, 8), (4096, 12), (65536, 8), (2048, 1),
                 (4096, 16)]
GAMMA = 0.02         # the reference's kernel test


def _close(port, want):
    port, want = npy(port), np.asarray(want)
    assert port.shape == want.shape
    assert np.abs(port - want).max() <= ROT_TOL * np.abs(want).max()


@pytest.mark.parametrize("n,r,c", [(1, 128, 128), (3, 128, 128),
                                   (4, 64, 64), (2, 128, 64), (7, 16, 16)])
def test_hadamard_blocks_match_reference(n, r, c):
    x = gauss(n * r + c, (n, r, c))
    out = hd.hadamard_blocks(tt(x))
    assert out.dtype == torch.float32
    _close(out, ref_ops.hadamard_blocks(jnp.asarray(x)))
    _close(out, ref_oracles.hadamard_ref(jnp.asarray(x)))


def test_hadamard_blocks_bf16_input_matches_reference():
    x = gauss(11, (2, 128, 128))
    x_ref = jnp.asarray(x).astype(jnp.bfloat16)
    x_port = tt(x).to(torch.bfloat16)
    np.testing.assert_array_equal(npy(x_port.float()),
                                  np.asarray(x_ref.astype(jnp.float32)))
    out = hd.hadamard_blocks(x_port)
    assert out.dtype == torch.float32
    _close(out, ref_ops.hadamard_blocks(x_ref))
    assert torch.equal(out, hd.hadamard_blocks(x_port.float()))


def test_hadamard_blocks_is_its_own_inverse():
    x = tt(gauss(12, (3, 128, 64)))
    back = hd.hadamard_blocks(hd.hadamard_blocks(x))
    assert float((back - x).abs().max()) <= ROT_TOL * float(x.abs().max())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("target", ["rotate_pallas", "rotate"])
def test_rotate_blocks_matches_reference(target, inverse):
    d = 50_000
    key = jax.random.PRNGKey(2)
    padded = pad_len(d)
    sg = np.asarray(_signs(key, padded))
    ref_fn = ref_ops.rotate_pallas if target == "rotate_pallas" \
        else ref_rotate
    x = gauss(13, (d,))
    if inverse:   # the inverse takes the padded rotated vector
        x = np.asarray(ref_rotate(jnp.asarray(x), key))
    want = ref_fn(jnp.asarray(x), key, inverse=inverse)
    _close(ops.rotate_blocks(tt(x), tt(sg), inverse=inverse), want)


def test_rotate_blocks_round_trip_and_agrees_with_plain_rotate():
    from repro_torch.compression.rotation import rotate
    d = 50_000
    x = tt(gauss(14, (d,)))
    sg = tt(np.asarray(_signs(jax.random.PRNGKey(3), pad_len(d))))
    y = ops.rotate_blocks(x, sg)
    assert torch.equal(y, rotate(x, sg))
    back = ops.rotate_blocks(y, sg, inverse=True)[:d]
    assert float((back - x).abs().max()) <= ROT_TOL * float(x.abs().max())


def _lattice_inputs(d, seed=3):
    y = gauss(seed, (d,), 2.0)
    u = uniform(seed + 1, (d,))
    w = y + gauss(seed + 2, (d,), 0.001)
    return y, u, w


@pytest.mark.parametrize("d,bits", LATTICE_CASES)
def test_lattice_encode_codes_equal_reference(d, bits):
    y, u, _ = _lattice_inputs(d)
    codes = lq.lattice_encode(tt(y), tt(u), GAMMA, bits=bits)
    assert codes.dtype == torch.int32 and tuple(codes.shape) == (d,)
    want = np.asarray(ref_ops.lattice_encode(jnp.asarray(y), jnp.asarray(u),
                                             GAMMA, bits=bits))
    np.testing.assert_array_equal(npy(codes), want.astype(np.int64))
    np.testing.assert_array_equal(
        want, np.asarray(ref_oracles.lattice_encode_ref(
            jnp.asarray(y), jnp.asarray(u), GAMMA, bits)))
    assert (y < 0).any() and (y > 0).any()    # the floored modulo is hit


@pytest.mark.parametrize("d,bits", LATTICE_CASES)
def test_lattice_decode_bit_equal_reference(d, bits):
    y, u, w = _lattice_inputs(d)
    codes_ref = ref_ops.lattice_encode(jnp.asarray(y), jnp.asarray(u), GAMMA,
                                       bits=bits)
    codes = tt(np.asarray(codes_ref).astype(np.int32))
    out = lq.lattice_decode(codes, tt(w), GAMMA, bits=bits)
    want = np.asarray(ref_ops.lattice_decode(codes_ref, jnp.asarray(w),
                                             GAMMA, bits=bits))
    np.testing.assert_array_equal(npy(out), want)
    np.testing.assert_array_equal(
        want, np.asarray(ref_oracles.lattice_decode_ref(
            codes_ref, jnp.asarray(w), GAMMA, bits)))
    # end to end: the reconstruction is within γ of y per coordinate
    # wherever the snap window ±2^bits·γ/2 holds |w/γ − code| (γ from the
    # rounding plus |w − y|; at bits=1 it does not)
    if (1 << bits) / 2 * GAMMA > GAMMA + float(np.abs(w - y).max()):
        assert float(np.abs(npy(out) - y).max()) <= GAMMA * 1.001


@pytest.mark.parametrize("gamma", [torch.tensor(GAMMA),
                                   torch.tensor([GAMMA])])
def test_lattice_gamma_tensor_equals_number(gamma):
    y, u, w = (tt(a) for a in _lattice_inputs(4096, seed=7))
    codes = lq.lattice_encode(y, u, gamma)
    assert torch.equal(codes, lq.lattice_encode(y, u, GAMMA))
    assert torch.equal(lq.lattice_decode(codes, w, gamma),
                       lq.lattice_decode(codes, w, GAMMA))


def test_ops_reexports_the_kernels():
    assert ops.hadamard_blocks is hd.hadamard_blocks
    assert ops.lattice_encode is lq.lattice_encode
    assert ops.lattice_decode is lq.lattice_decode
    assert ops.flash_attention is fa.flash_attention


def test_refusals():
    y, u, w = (tt(a) for a in _lattice_inputs(2048))
    codes = lq.lattice_encode(y, u, GAMMA)
    with pytest.raises(ValueError, match="multiple of 1024"):
        lq.lattice_encode(y[:1000], u[:1000], GAMMA)
    with pytest.raises(ValueError, match="multiple of 1024"):
        lq.lattice_decode(codes[:1536], w[:1536], GAMMA)
    for bits in (0, 17):
        with pytest.raises(ValueError, match="bits"):
            lq.lattice_encode(y, u, GAMMA, bits=bits)
    with pytest.raises(ValueError, match="codes"):
        lq.lattice_decode(codes.to(torch.int64), w, GAMMA)
    with pytest.raises(ValueError, match="w:"):
        lq.lattice_decode(codes, w[:1024], GAMMA)
    with pytest.raises(ValueError, match="u:"):
        lq.lattice_encode(y, u.double(), GAMMA)
    with pytest.raises(ValueError, match="gamma"):
        lq.lattice_encode(y, u, torch.tensor([GAMMA, GAMMA]))
    with pytest.raises(ValueError, match="power of two"):
        hd.hadamard_blocks(torch.zeros((2, 96, 128)))
    with pytest.raises(ValueError, match="power of two"):
        hd.hadamard_blocks(torch.zeros((2, 128, 48)))
    with pytest.raises(ValueError, match="exceeds 32768"):
        hd.hadamard_blocks(torch.zeros((1, 256, 256)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hd.hadamard_blocks(torch.zeros((1, 16, 16), dtype=torch.float64))
    with pytest.raises(ValueError, match="signs"):
        ops.rotate_blocks(y, torch.ones(1024))


def test_mixed_devices_are_refused_and_nothing_launches():
    """A mix of ``meta`` and real tensors raises; all-``meta`` inputs (an
    abstract run) get empty outputs of the right shapes and dtypes; no
    wrapper falls back to the plain version or launches."""
    hd.reset_launches()
    lq.reset_launches()
    y = torch.zeros(1024)
    meta = torch.empty(1024, device="meta")
    with pytest.raises(ValueError, match="meta tensors only together"):
        lq.lattice_encode(y, meta, GAMMA)
    with pytest.raises(ValueError, match="meta tensors only together"):
        lq.lattice_decode(torch.zeros(1024, dtype=torch.int32), y,
                          torch.tensor(GAMMA, device="meta"))
    out = hd.hadamard_blocks(torch.empty((1, 32, 32), device="meta"))
    assert (out.device.type, out.shape, out.dtype) == (
        "meta", (1, 32, 32), torch.float32)
    out = ops.rotate_blocks(meta, meta)
    assert out.device.type == "meta" and out.shape == meta.shape
    # the CPU path launches nothing
    lq.lattice_decode(lq.lattice_encode(y, y, GAMMA), y, GAMMA)
    ops.rotate_blocks(y, torch.ones(1024))
    assert hd.LAUNCHES == {"hadamard_blocks": 0}
    assert lq.LAUNCHES == {"lattice_encode": 0, "lattice_decode": 0}
