"""The exchange pipeline, the codecs and the rotation budget against
``repro.compression``.

``quafl_round`` gets the reference's own randomness (its signs and rounding
noise) and must land within one lattice step, max(γ_up, γ_dn), of both the
reference's rotated-space round and its per-message oracle: the two sides
may round a code differently only where y/γ+u sits on an integer boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import gauss, npy, tt
from repro.compression import codecs as ref_codecs
from repro.compression import pipeline as ref_pipe
from repro.configs.base import FedConfig as RefFedConfig
from repro_torch.analysis.opbudget import rotation_budget
from repro_torch.compression import codecs, pipeline
from repro_torch.configs.base import FedConfig

D, S = 2762, 4     # quickstart's MLP: d_pad 4096, one 64x64 block


def _inputs(seed=0):
    server = gauss(seed, (D,), 0.05)
    Y = server[None] + gauss(seed + 1, (S, D), 0.01)
    hints = np.linalg.norm(Y - server[None], axis=1).astype(np.float32)
    return server, Y, hints


def _wires(kind):
    if kind == "b8":
        return (ref_pipe.LatticeWire(8), ref_pipe.LatticeWire(8),
                pipeline.LatticeWire(8), pipeline.LatticeWire(8))
    if kind == "b4_packed":
        return (ref_pipe.LatticeWire(4, 2), ref_pipe.LatticeWire(8),
                pipeline.LatticeWire(4, 2), pipeline.LatticeWire(8))
    levels = np.array([256.0, 16.0, 256.0, 64.0], np.float32)
    return (ref_pipe.LatticeWire(8, 1, jnp.asarray(levels)),
            ref_pipe.LatticeWire(8),
            pipeline.LatticeWire(8, 1, tt(levels)), pipeline.LatticeWire(8))


@pytest.mark.parametrize("wire", ["b8", "b4_packed", "levels"])
@pytest.mark.parametrize("avg_mode", ["both", "server_only", "client_only"])
def test_quafl_round_matches_reference(avg_mode, wire):
    server, Y, hints = _inputs()
    key = jax.random.PRNGKey(3)
    ref = ref_pipe.ExchangePipeline(bits=8, backend="jnp")
    up_j, dn_j, up_t, dn_t = _wires(wire)
    sg, u_cl, u_srv = ref._round_randomness(key, S, D)
    outs_ref = [fn(key, jnp.asarray(server), jnp.asarray(Y),
                   jnp.asarray(hints), avg_mode=avg_mode, up=up_j,
                   down=dn_j)
                for fn in (ref.quafl_round, ref.quafl_round_reference)]
    port = pipeline.ExchangePipeline(bits=8, backend="cuda")
    srv, cl, hint_srv, rel = port.quafl_round(
        tt(server), tt(Y), tt(hints), signs=tt(sg), u_cl=tt(u_cl),
        u_srv=tt(u_srv), avg_mode=avg_mode, up=up_t, down=dn_t)
    assert port.stats.counts() == rotation_budget(S)
    g_up = ref.gammas(jnp.asarray(hints), jnp.linalg.norm(jnp.asarray(Y),
                                                          axis=1), D, up_j)
    g_dn = ref.gammas(outs_ref[0][2][None],
                      jnp.linalg.norm(jnp.asarray(server))[None], D, dn_j)
    step = float(max(jnp.max(g_up), jnp.max(g_dn)))
    for srv_r, cl_r, hint_r, rel_r in outs_ref:
        assert np.abs(npy(srv) - npy(srv_r)).max() <= step
        assert np.abs(npy(cl) - npy(cl_r)).max() <= step
        np.testing.assert_allclose(float(hint_srv), float(hint_r),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(rel), float(rel_r), rtol=1e-2)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_rotated_round_matches_port_oracle(backend):
    server, Y, hints = _inputs(5)
    g = torch.Generator()
    g.manual_seed(0)
    sg, u_cl, u_srv = pipeline.round_randomness(g, S, D)
    p = pipeline.ExchangePipeline(bits=8, backend=backend)
    kw = dict(signs=sg, u_cl=u_cl, u_srv=u_srv)
    a = p.quafl_round(tt(server), tt(Y), tt(hints), **kw)
    b = p.quafl_round_reference(tt(server), tt(Y), tt(hints), **kw)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(npy(x), npy(y), atol=2e-5)


def test_round_randomness_shapes():
    g = torch.Generator()
    g.manual_seed(1)
    sg, u_cl, u_srv = pipeline.round_randomness(g, S, D)
    assert sg.shape == (4096,) and u_cl.shape == (S, 4096)
    assert u_srv.shape == (1, 4096)
    assert float(u_cl.min()) >= 0.0 and float(u_cl.max()) < 1.0
    with pytest.raises(ValueError, match="generator"):
        pipeline.ExchangePipeline().quafl_round(
            torch.zeros(D), torch.zeros((S, D)), torch.ones(S))


def test_gammas_match_reference():
    rng = np.random.default_rng(0)
    hints = rng.random(5).astype(np.float32)
    norms = (rng.random(5) * 10).astype(np.float32)
    for d in (2762, 25_450):
        for wire_j, wire_t in ((ref_pipe.LatticeWire(8),
                                pipeline.LatticeWire(8)),
                               (ref_pipe.LatticeWire(4, 2),
                                pipeline.LatticeWire(4, 2))):
            g_ref = ref_pipe.ExchangePipeline().gammas(
                jnp.asarray(hints), jnp.asarray(norms), d, wire_j)
            g = pipeline.ExchangePipeline().gammas(tt(hints), tt(norms), d,
                                                   wire_t)
            np.testing.assert_allclose(npy(g), npy(g_ref), rtol=1e-6)


def test_backend_registry():
    assert pipeline.get_backend("cuda").name == "cuda"
    assert pipeline.get_backend("torch").name == "torch"
    with pytest.raises(ValueError, match="unknown kernel backend"):
        pipeline.get_backend("pallas")


@pytest.mark.parametrize("spec", ["lattice", "lattice_packed",
                                  "lattice_packed:bits=4",
                                  "lattice_packed:bits=2", "lattice:bits=4",
                                  "lattice:bits=12"])
def test_codec_bits_match_reference(spec):
    ref = ref_codecs.make_codec(spec)
    port = codecs.make_codec(spec)
    assert (port.bits, port.pack, port.name) == (ref.bits, ref.pack,
                                                 ref.name)
    assert port.wire() == (ref.wire().bits, ref.wire().pack, None)
    for d in (2762, 25_450, 1 << 20):
        assert port.message_bits(d) == ref.message_bits(d)
    assert codecs.is_lattice_family(port)


def test_codec_bits_of_the_main_path():
    up8, up4 = codecs.make_codec("lattice"), codecs.make_codec(
        "lattice_packed:bits=4")
    assert 4 * up8.message_bits(2762) == 131_200
    assert up8.message_bits(2762) == 32_800
    assert 16 * up8.message_bits(25_450) == 4_194_816
    assert up8.message_bits(25_450) == 262_176
    assert 16 * up4.message_bits(25_450) == 2_097_664


def test_codec_spec_errors():
    with pytest.raises(ValueError, match="unknown codec"):
        codecs.make_codec("nope")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        codecs.make_codec("topk_ef:frac=0.1")
    with pytest.raises(ValueError, match="unknown codec parameter"):
        codecs.make_codec("scalar:frac=0.1")
    with pytest.raises(ValueError, match="malformed"):
        codecs.make_codec("lattice:bits")
    with pytest.raises(ValueError, match="unknown codec parameter"):
        codecs.make_codec("lattice:frac=0.1")
    with pytest.raises(ValueError, match="lattice_packed needs"):
        codecs.make_codec("lattice_packed:bits=3")
    # a group map needs the speed classes; with them it resolves to the
    # reference's per-client bit budgets and wire widths
    spec = {"fast": "lattice", "slow": "lattice_packed:bits=4"}
    for resolve in (codecs.resolve_codec, ref_codecs.resolve_codec):
        with pytest.raises(ValueError, match="slow_mask"):
            resolve(spec, None, direction="up")
    mask = np.arange(16) < 5
    got = codecs.resolve_codec(spec, FedConfig(), direction="up",
                               slow_mask=mask)
    want = ref_codecs.resolve_codec(spec, RefFedConfig(), direction="up",
                                    slow_mask=mask)
    assert isinstance(got, codecs.GroupedLatticeCodec)
    assert got.bits_per_client == want.bits_per_client
    assert got.wire_width_per_client == want.wire_width_per_client


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("wire", ["b8", "b4_packed"])
def test_pipeline_decode_matches_reference(backend, wire):
    """``ExchangePipeline.decode``: the fused Dec(ref, msg) of s messages
    against one reference, with the reference's rotation counts (one
    forward per reference row, one inverse per message)."""
    server, Y, hints = _inputs(5)
    up_j, _, up_t, _ = _wires(wire)
    ref = ref_pipe.ExchangePipeline(bits=8, backend="jnp")
    sg, u_cl, _ = ref._round_randomness(jax.random.PRNGKey(4), S, D)
    gam = ref.gammas(jnp.asarray(hints), jnp.linalg.norm(jnp.asarray(Y),
                                                         axis=1), D, up_j)
    codes = ref.rotate_encode(jnp.asarray(Y), sg, u_cl, gam,
                              want_rotated=False, wire=up_j)
    want = ref.decode(codes, jnp.asarray(server)[None], sg, gam, D, up_j)
    port = pipeline.ExchangePipeline(bits=8, backend=backend)
    ccodes = tt(npy(codes).astype(np.int32 if up_t.pack == 1 else np.uint8))
    out = port.decode(ccodes, tt(server[None]), tt(sg), tt(gam), D, up_t)
    assert out.shape == (S, D)
    assert port.stats.counts() == {"rotation_fwd": 1, "rotation_inv": S}
    # the reference's count also holds the S forward passes of its encode
    assert (ref.stats.fwd - S, ref.stats.inv) == (1, S)
    np.testing.assert_allclose(npy(out), npy(want), rtol=0,
                               atol=1e-5 * np.abs(Y).max())
