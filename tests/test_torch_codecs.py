"""The per-message codec API against the reference: ``LatticeQuantizer``
and ``LatticeCodec`` (packed and unpacked), ``ScalarCodec`` and
``IdentityCodec``, with each :class:`MessageKey` built from the reference
key's own signs and rounding noise.

Tolerances: codes equal except ±1 (mod L for lattice) on at most 1e-4 of
the coordinates (where y/γ+u sits on an integer boundary and the two
rotations, or the two norms, round to either side); decoded values within
one quantization step (γ for lattice, ‖x‖/levels for scalar); identity
exact; ``message_bits`` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import circular_gap, gauss, npy, tt
from repro.compression import codecs as ref_codecs
from repro.compression import lattice as ref_lattice
from repro.compression.rotation import _signs as ref_signs
from repro.configs.base import FedConfig as RefFedConfig
from repro_torch.compression import codecs, lattice
from repro_torch.compression.lattice import MessageKey
from repro_torch.compression.rotation import pad_len
from repro_torch.configs.base import FedConfig
from repro_torch.kernels import exchange as kx

D = 2762                 # the 32-64-10 MLP: d_pad 4096
MISMATCH_FRAC = 1e-4


def _keys(seed, m):
    return [jax.random.PRNGKey(seed + i) for i in range(m)]


def lattice_key(keys, d, block=16_384) -> MessageKey:
    """The reference ``LatticeQuantizer``'s draws of each key
    (``lattice.py:90-92``) as one batched key."""
    d_pad = pad_len(d, block)
    sg, u = [], []
    for k in keys:
        krot, krnd = jax.random.split(k)
        sg.append(npy(ref_signs(krot, d_pad)))
        u.append(npy(jax.random.uniform(krnd, (d_pad,), jnp.float32)))
    return MessageKey(tt(np.stack(sg)), tt(np.stack(u)))


def scalar_key(keys, d) -> MessageKey:
    """The reference ``QSGDQuantizer``'s rounding noise of each key."""
    return MessageKey(u=tt(np.stack([npy(jax.random.uniform(
        k, (d,), jnp.float32)) for k in keys])))


def _messages(m=3, seed=0):
    base = gauss(seed, (D,))
    x = base[None] + 0.05 * gauss(seed + 1, (m, D))
    ref = base + 0.01 * gauss(seed + 2, (D,))
    hints = np.linalg.norm(x - ref[None], axis=1).astype(np.float32) + 1e-3
    return x.astype(np.float32), ref.astype(np.float32), hints


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("ref_backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("bits", [8, 4])
def test_lattice_quantizer_matches_reference(backend, ref_backend, bits):
    m = 3
    x, ref, hints = _messages(m)
    keys = _keys(100, m)
    rq = ref_lattice.LatticeQuantizer(bits=bits, backend=ref_backend)
    q = lattice.LatticeQuantizer(bits=bits, backend=backend)
    key = lattice_key(keys, D)
    msg = q.encode(key, tt(x), tt(hints))
    out = q.decode(key, msg, tt(ref[None]))
    assert out.shape == (m, D)
    for i in range(m):
        rmsg = rq.encode(keys[i], jnp.asarray(x[i]), hints[i])
        rout = rq.decode(keys[i], rmsg, jnp.asarray(ref))
        g = float(rmsg.gamma)
        np.testing.assert_allclose(float(msg.gamma[i]), g, rtol=1e-5)
        gap = circular_gap(npy(msg.codes[i]), npy(rmsg.codes), 1 << bits)
        assert gap.max() <= 1
        assert (gap > 0).sum() <= MISMATCH_FRAC * gap.size
        assert np.abs(npy(out[i]) - npy(rout)).max() <= g
    # Lemma 3.1: the decode is within γ·sqrt(d_pad) of x
    err = np.linalg.norm(npy(out) - x, axis=1)
    assert (err <= npy(msg.gamma) * np.sqrt(4096)).all()


@pytest.mark.parametrize("spec,bits", [("lattice", 8), ("lattice", 4),
                                       ("lattice_packed:bits=4", 4),
                                       ("lattice_packed:bits=8", 8)])
def test_lattice_codec_matches_reference(spec, bits):
    m = 4
    x, ref, hints = _messages(m, seed=5)
    keys = _keys(200, m)
    rc = ref_codecs.make_codec(spec, bits=bits)
    c = codecs.make_codec(spec, bits=bits, backend="torch")
    assert c.pack == rc.pack and c.name == rc.name
    key = lattice_key(keys, D)
    # against a reference near x, and against the zero vector with hint
    # ‖x‖, as the delta uplinks use it
    zero_hints = np.linalg.norm(x, axis=1).astype(np.float32) + 1e-12
    for r, h in ((ref, hints), (np.zeros(D, np.float32), zero_hints)):
        msg = c.encode(key, tt(x), tt(h))
        assert msg.codes.dtype == (torch.uint8 if c.pack > 1
                                   else torch.int32)
        assert msg.codes.shape == (m, 4096 // c.pack)
        out = c.decode(key, msg, tt(r[None]))
        for i in range(m):
            rmsg = rc.encode(keys[i], jnp.asarray(x[i]), h[i])
            rout = rc.decode(keys[i], rmsg, jnp.asarray(r))
            a = npy(msg.codes[i:i + 1])
            b = npy(rmsg.codes)[None]
            if c.pack > 1:
                a = npy(kx.unpack_codes(tt(a), bits=bits))
                b = npy(kx.unpack_codes(tt(b), bits=bits))
            gap = circular_gap(a, b, 1 << bits)
            assert gap.max() <= 1
            assert (gap > 0).sum() <= MISMATCH_FRAC * gap.size
            assert np.abs(npy(out[i]) - npy(rout)).max() <= float(rmsg.gamma)


@pytest.mark.parametrize("bits", [8, 4])
def test_scalar_codec_matches_reference(bits):
    m = 3
    x, _, _ = _messages(m, seed=9)
    keys = _keys(300, m)
    rc = ref_codecs.make_codec(f"scalar:bits={bits}")
    c = codecs.make_codec(f"scalar:bits={bits}")
    key = scalar_key(keys, D)
    msg = c.encode(key, tt(x))
    assert msg.codes.dtype == torch.int8
    out = c.decode(key, msg, None)
    for i in range(m):
        rmsg = rc.encode(keys[i], jnp.asarray(x[i]))
        gap = np.abs(npy(msg.codes[i]).astype(np.int64)
                     - npy(rmsg.codes).astype(np.int64))
        assert gap.max() <= 1
        assert (gap > 0).sum() <= MISMATCH_FRAC * gap.size
        np.testing.assert_allclose(float(msg.gamma[i]), float(rmsg.gamma),
                                   rtol=1e-5)
        step = float(rmsg.gamma) / rc.quant.levels
        rout = rc.decode(keys[i], rmsg, None)
        assert np.abs(npy(out[i]) - npy(rout)).max() <= step * 1.0001


def test_identity_codec_is_exact():
    x, _, _ = _messages(2)
    c, rc = codecs.make_codec("identity"), ref_codecs.make_codec("identity")
    key = c.keys(torch.Generator(), 2, D)
    assert key == MessageKey()
    out = c.decode(key, c.encode(key, tt(x)), None)
    np.testing.assert_array_equal(npy(out), x)
    rout = rc.decode(None, rc.encode(None, jnp.asarray(x[0])), None)
    np.testing.assert_array_equal(npy(out[0]), npy(rout))


@pytest.mark.parametrize("d", [2762, 25_450])
@pytest.mark.parametrize("spec", ["lattice", "lattice_packed:bits=4",
                                  "lattice:bits=4", "scalar", "scalar:bits=4",
                                  "identity"])
def test_message_bits_match_reference(spec, d):
    assert (codecs.make_codec(spec).message_bits(d)
            == ref_codecs.make_codec(spec).message_bits(d))


def test_quantizers_message_bits_and_keys():
    g = torch.Generator()
    g.manual_seed(0)
    for name in ("lattice", "qsgd", "none"):
        q, rq = lattice.make_quantizer(name, 8), ref_lattice.make_quantizer(
            name, 8)
        assert q.message_bits(D) == rq.message_bits(D)
    key = lattice.LatticeQuantizer().keys(g, 3, D)
    assert key.signs.shape == key.u.shape == (3, 4096)
    assert set(np.unique(npy(key.signs))) == {-1.0, 1.0}
    assert key.row(1).signs.shape == (1, 4096)
    assert lattice.QSGDQuantizer().keys(g, 2, D).u.shape == (2, D)
    with pytest.raises(ValueError):
        lattice.make_quantizer("nope", 8)


def test_resolve_codec_precedence_matches_reference():
    fed, ref_fed = FedConfig(bits=4), RefFedConfig(bits=4)
    cases = [(None, {}, None), (None, {}, "identity"),
             ("scalar", {}, "identity"),
             (None, {"codec_up": "lattice_packed"}, "identity"),
             (None, {"quantizer": "qsgd"}, None),
             (None, {"quantizer": "none"}, None)]
    for spec, over, default in cases:
        f = FedConfig(bits=4, **over)
        rf = RefFedConfig(bits=4, **over)
        c = codecs.resolve_codec(spec, f, direction="up", default=default)
        rc = ref_codecs.resolve_codec(spec, rf, direction="up",
                                      default=default)
        assert (c.name, c.bits) == (rc.name, rc.bits)
        assert c.message_bits(D) == rc.message_bits(D)
    assert codecs.resolve_codec(None, fed, direction="up").backend == "cuda"
    assert ref_fed.bits == 4
