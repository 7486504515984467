"""``decode_plain`` (the CPU path of the ``fused_decode`` wrapper) against
the reference's ``fused_decode`` in interpret mode and ``_decode_jnp``.

Codes come from encoding x; the references are x plus a perturbation well
inside the wrap window, as the codecs use them. Codes and references
broadcast along the message axis; the levels row and per-message sign rows
(the reference: ``jax.vmap`` of ``fused_decode`` over the rows) are covered.

Tolerance: max |Δ| ≤ 1e-5·max|x|. Both sides snap the same codes against
the same reference, so the snapped points agree; what differs is the
rotation (a butterfly here, two matmuls there), measured at ≤ 3.5e-7
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_harness import gauss, npy, signs_np, tt, uniform
from repro.compression import pipeline as ref_pipe
from repro.kernels import exchange as ref_kx
from repro_torch.kernels import exchange as kx

TOL = 1e-5
WIRES = [(8, 1), (4, 2)]
D_PADS = [4096, 8192]


def _case(m, d_pad, bits, pack, seed, levels=None, sign_rows=False):
    """x, references, signs, γ, levels and the codes of x (port dtypes).
    The rows of x lie close together, so any one of them, perturbed, is a
    sound reference for all."""
    x = gauss(seed, (1, d_pad)) + 0.05 * gauss(seed + 4, (m, d_pad))
    sg = (np.stack([signs_np(seed + 10 + i, d_pad) for i in range(m)])
          if sign_rows else signs_np(seed + 1, d_pad))
    u = uniform(seed + 2, (m, d_pad))
    L = (np.full(m, 1 << bits, np.float32) if levels is None
         else np.asarray(levels, np.float32))
    y = npy(kx.rotate_plain(tt(x), tt(sg)))
    gam = (np.abs(y).max(axis=1) / L / 2).astype(np.float32)
    lv = None if levels is None else tt(L)
    codes = kx.encode_plain(tt(x), tt(sg), tt(u), tt(gam), bits=bits,
                            pack=pack, levels2=lv)
    ref = x + 0.1 * gam[:, None] * gauss(seed + 3, (m, d_pad))
    return x, ref.astype(np.float32), sg, gam, L, codes


def _ref_codes(codes, pack):
    return jnp.asarray(npy(codes).astype(np.uint8 if pack > 1 else np.uint32))


def _check(out, want, x):
    err = np.abs(npy(out) - np.asarray(want)).max()
    assert err <= TOL * np.abs(x).max(), err


@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("d_pad", D_PADS)
@pytest.mark.parametrize("mc,mr", [(1, 4), (4, 1), (4, 4)])
def test_decode_plain_matches_reference(bits, pack, d_pad, mc, mr):
    m = max(mc, mr)
    x, ref, sg, gam, _, codes = _case(m, d_pad, bits, pack, seed=d_pad + m)
    codes, ref = codes[:mc], ref[:mr]
    g = gam if mc == m else gam[:1]
    out = kx.decode_plain(codes, tt(ref), tt(sg), tt(g), bits=bits,
                          pack=pack)
    assert out.shape == (m, d_pad)
    args = (_ref_codes(codes, pack), jnp.asarray(ref), jnp.asarray(sg),
            jnp.asarray(g))
    _check(out, ref_kx.fused_decode(*args, bits=bits, pack=pack,
                                    interpret=True), x)
    _check(out, ref_pipe._decode_jnp(*args, bits=bits, pack=pack), x)
    # Lemma 3.1: ‖Q(x) − x‖ ≤ γ·sqrt(d_pad)
    if mc == m:
        err = np.linalg.norm(npy(out) - x, axis=1)
        assert (err <= gam * np.sqrt(d_pad)).all(), err


@pytest.mark.parametrize("bits,pack", WIRES)
def test_decode_plain_with_levels_row(bits, pack):
    m, d_pad = 4, 4096
    levels = [1 << bits, 16.0, 64.0 if bits == 8 else 4.0, 1 << bits]
    x, ref, sg, gam, L, codes = _case(m, d_pad, bits, pack, seed=7,
                                      levels=levels)
    out = kx.decode_plain(codes, tt(ref[:1]), tt(sg), tt(gam), bits=bits,
                          pack=pack, levels2=tt(L))
    args = (_ref_codes(codes, pack), jnp.asarray(ref[:1]), jnp.asarray(sg),
            jnp.asarray(gam))
    kw = dict(bits=bits, pack=pack, levels2=jnp.asarray(L))
    _check(out, ref_kx.fused_decode(*args, interpret=True, **kw), x)
    _check(out, ref_pipe._decode_jnp(*args, **kw), x)


@pytest.mark.parametrize("bits,pack", WIRES)
@pytest.mark.parametrize("mr", [1, 4])
def test_decode_plain_with_sign_rows(bits, pack, mr):
    """One sign row per message: the per-message codec API's rotation."""
    m, d_pad = 4, 8192
    x, ref, sg, gam, _, codes = _case(m, d_pad, bits, pack, seed=11,
                                      sign_rows=True)
    ref = ref[:mr]
    out = kx.decode_plain(codes, tt(ref), tt(sg), tt(gam), bits=bits,
                          pack=pack)

    def one(c, r, s, g):
        return ref_kx.fused_decode(c[None], r[None], s, g[None], bits=bits,
                                   pack=pack, interpret=True)[0]
    refs = jnp.broadcast_to(jnp.asarray(ref), (m, d_pad))
    want = jax.vmap(one)(_ref_codes(codes, pack), refs, jnp.asarray(sg),
                         jnp.asarray(gam))
    _check(out, want, x)


def test_encode_plain_with_sign_rows_matches_per_message_encodes():
    """Per-message sign rows in one batched encode equal m encodes of one
    message each."""
    m, d_pad, bits = 3, 4096, 8
    x = gauss(0, (m, d_pad))
    sg = np.stack([signs_np(i, d_pad) for i in range(m)])
    u = uniform(1, (m, d_pad))
    gam = np.full(m, 0.01, np.float32)
    y, codes = kx.encode_plain(tt(x), tt(sg), tt(u), tt(gam), bits=bits,
                               want_rotated=True)
    for i in range(m):
        yi, ci = kx.encode_plain(tt(x[i:i + 1]), tt(sg[i]), tt(u[i:i + 1]),
                                 tt(gam[i:i + 1]), bits=bits,
                                 want_rotated=True)
        np.testing.assert_array_equal(npy(y[i:i + 1]), npy(yi))
        np.testing.assert_array_equal(npy(codes[i:i + 1]), npy(ci))


def test_decode_is_rotate_snap_unrotate():
    """decode_plain is exactly the composition of the plain rotation, snap
    and inverse rotation (the kernel runs the same steps in that order)."""
    x, ref, sg, gam, _, codes = _case(4, 4096, 8, 1, seed=3)
    w = kx.rotate_plain(tt(ref), tt(sg))
    q = kx.snap_plain(codes, w, tt(gam))
    want = kx.rotate_plain(q, tt(sg), inverse=True)
    np.testing.assert_array_equal(
        npy(kx.decode_plain(codes, tt(ref), tt(sg), tt(gam))), npy(want))
    np.testing.assert_array_equal(
        npy(kx.fused_decode(codes, tt(ref), tt(sg), tt(gam))), npy(want))
