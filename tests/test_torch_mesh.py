"""The mesh path's pure functions in the port against the JAX reference:
the sharding rules (``pspec_for`` on fake meshes), the leaf-wise bits, the
transports' extra downlink bits and byte budgets, the scatter-resident
coded redistribution, and the port's own block helpers and local mesh.

Tolerances: specs, bits, budgets and codes exact; the redistribution's
decodes bit-equal (the plain snap is the reference's arithmetic).
"""
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import npy, tt
from repro.compression import transports as ref_tr
from repro.compression.codecs import make_codec as ref_make_codec
from repro.compression.codecs import resolve_codec as ref_resolve_codec
from repro.compression.pipeline import ExchangePipeline as RefPipeline
from repro.compression.pipeline import LatticeWire as RefWire
from repro.configs import get_config as ref_get_config
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.transport import tree_bits as ref_tree_bits
from repro.models.model import abstract_lm as ref_abstract_lm
from repro.sharding import rules as ref_rules
from repro_torch.compression import transports
from repro_torch.compression.codecs import make_codec, resolve_codec
from repro_torch.compression.pipeline import ExchangePipeline, LatticeWire
from repro_torch.configs import get_config
from repro_torch.configs.base import FedConfig
from repro_torch.core.transport import tree_bits
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models.model import abstract_lm
from repro_torch.sharding import rules
from repro_torch.sharding.rules import block_shape, cut_block, join_blocks

LLAMA_BITS = 9_886_515_552     # 11 leaves, each padded on its own


class FakeMesh:
    def __init__(self, shape, axes):
        self.shape = OrderedDict(zip(axes, shape))


MESHES = {"16x16": FakeMesh((16, 16), ("data", "model")),
          "4x2": FakeMesh((4, 2), ("data", "model")),
          "2x2x2": FakeMesh((2, 2, 2), ("pod", "data", "model"))}
RULES = ("client_dp", "cohort", "ep")


def test_pspec_divisibility_fallback_matches_reference():
    """The cases of ``tests/test_distributed.py``'s rule test."""
    fm = MESHES["16x16"]
    cases = [((40, 128), ("q_flat", None), "RULES_TP"),
             ((5120, 5120), ("embed", "q_flat"), "RULES_TP"),
             ((16, 16), ("clients", "batch"), "RULES_TP"),
             ((1024, 4096), ("embed", "mlp"), "RULES_FSDP"),
             ((1, 524288, 8, 128), ("batch", "kv_seq", None, None),
              "RULES_TP")]
    want = [(), (None, "model"), ("data",), ("data", "model"),
            (None, "data")]
    for (shape, axes, rs), w in zip(cases, want):
        got = rules.pspec_for(shape, axes, getattr(rules, rs), fm)
        ref = ref_rules.pspec_for(shape, axes, getattr(ref_rules, rs), fm)
        assert got == tuple(ref) == w, (shape, axes, got, ref)
    m11 = FakeMesh((1, 1), ("data", "model"))
    assert rules.pspec_for((40, 128), ("q_flat", None), rules.RULES_TP,
                           m11) == ("model",)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b", "olmo-1b",
                                  "gemma3-12b", "mamba2-370m",
                                  "llama4-scout-17b-a16e", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_pspec_for_every_leaf_matches_reference(arch, mesh):
    spec, axes = abstract_lm(get_config(arch))
    rspec, raxes = ref_abstract_lm(ref_get_config(arch))
    assert sorted(spec) == sorted(rspec)
    fm = MESHES[mesh]
    for k, v in spec.items():
        assert tuple(v.shape) == tuple(rspec[k].shape), k
        assert tuple(axes[k]) == tuple(raxes[k]), k
        for mode in RULES:
            got = rules.pspec_for(tuple(v.shape), axes[k],
                                  rules.rules_for_mode(mode), fm)
            ref = ref_rules.pspec_for(tuple(v.shape), axes[k],
                                      ref_rules.rules_for_mode(mode), fm)
            assert got == tuple(ref), (k, mode, got, ref)
            cl = rules.pspec_for((4,) + tuple(v.shape),
                                 ("clients",) + tuple(axes[k]),
                                 rules.rules_for_mode(mode), fm)
            rcl = ref_rules.pspec_for((4,) + tuple(v.shape),
                                      ("clients",) + tuple(axes[k]),
                                      ref_rules.rules_for_mode(mode), fm)
            assert cl == tuple(rcl), (k, mode, cl, rcl)


def test_tree_bits_at_full_width_from_shapes():
    spec, _ = abstract_lm(get_config("llama3.2-1b"))
    assert len(spec) == 11
    got = tree_bits(make_codec("lattice"), spec)
    rspec, _ = ref_abstract_lm(ref_get_config("llama3.2-1b"))
    assert got == ref_tree_bits(ref_make_codec("lattice"), rspec) == \
        LLAMA_BITS


def test_transport_extra_bits_down_matches_reference():
    """The cases of ``tests/test_codecs.py``'s extra-bits test."""
    d, n = 65536, 4
    up, dn = make_codec("lattice"), make_codec("lattice_packed:bits=4")
    rup, rdn = ref_make_codec("lattice"), ref_make_codec(
        "lattice_packed:bits=4")
    fed, rfed = FedConfig(n_clients=4, s=2, bits=8), RefFedConfig(
        n_clients=4, s=2, bits=8)
    group = {"fast": "lattice", "slow": "lattice:bits=4"}
    mask = np.array([1, 1, 0, 0], bool)
    g = resolve_codec(group, fed, direction="up", slow_mask=mask)
    rg = ref_resolve_codec(group, rfed, direction="up", slow_mask=mask)
    cases = [("shard_local", up, rup, dn, rdn, d, n, 0),
             ("code_allgather", up, rup, dn, rdn, d, n, (n - 1) * 32),
             ("code_allgather", g, rg, dn, rdn, d, n, 2 * (n - 1) * 32),
             ("reduce_scatter", up, rup, dn, rdn, d, n,
              dn.message_bits(d) + (n - 1) * 32),
             ("reduce_scatter", up, rup, dn, rdn, d, 1, 0),
             ("reduce_scatter", up, rup, dn, rdn, 3 * 16384, 4, 0),
             ("reduce_scatter", up, rup, make_codec("scalar:bits=6"),
              ref_make_codec("scalar:bits=6"), d, n, 0)]
    for name, cu, rcu, cd, rcd, dd, nn, want in cases:
        got = transports.make_transport(name).extra_bits_down(cu, cd, dd, nn)
        ref = ref_tr.make_transport(name).extra_bits_down(rcu, rcd, dd, nn)
        assert got == ref == want, (name, got, ref, want)


@pytest.mark.parametrize("codec", ["lattice", "lattice_packed:bits=4",
                                   "scalar:bits=6"])
def test_wire_budgets_match_reference(codec):
    for name in transports.registered_transports():
        for d, n in ((25_450, 4), (65_536, 4), (1_000_000, 2)):
            got = transports.make_transport(name).wire_budget(
                make_codec(codec), make_codec(codec), d, n)
            ref = ref_tr.make_transport(name).wire_budget(
                ref_make_codec(codec), ref_make_codec(codec), d, n)
            assert got.caps == dict(ref.caps), (name, codec, d, n)
            assert got.float_reduce_ok == ref.float_reduce_ok


def test_transport_registry_matches_reference():
    assert transports.registered_transports() == \
        ref_tr.registered_transports()
    for mode in ("shard_local", "dequant_psum", "shard_local_codes",
                 "shard_local_rs", "code_allgather"):
        got, ref = (transports.transport_for_mode(mode),
                    ref_tr.transport_for_mode(mode))
        assert (got is None) == (ref is None), mode
        if got is not None:
            assert got.name == ref.name
    for d_pad, n, pack in ((65_536, 4, 1), (65_536, 4, 2), (3 * 16_384, 4, 1),
                           (1 << 20, 8, 2), (16_384, 1, 1)):
        wire = LatticeWire(bits=8 // pack, pack=pack)
        assert transports._shardable(d_pad, n, wire) == ref_tr._shardable(
            d_pad, n, RefWire(bits=8 // pack, pack=pack)), (d_pad, n, pack)


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2)])
def test_scatter_encode_gather_matches_reference(bits, pack):
    n, d_pad = 4, 4 * 16_384
    rng = np.random.default_rng(bits)
    vec = rng.standard_normal((1, d_pad)).astype(np.float32)
    ref = (vec + 0.01 * rng.standard_normal((1, d_pad))).astype(np.float32)
    gam = np.array([0.004], np.float32)
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (n, d_pad // n), jnp.float32)
    rdec, rcodes = ref_tr.scatter_encode_gather(
        RefPipeline(bits=bits, backend="jnp"), RefWire(bits=bits, pack=pack),
        jnp.asarray(vec), jnp.asarray(ref), jnp.asarray(gam), key, n)
    dec, codes = transports.scatter_encode_gather(
        ExchangePipeline(bits=bits, backend="cuda"),
        LatticeWire(bits=bits, pack=pack), tt(vec), tt(ref), tt(gam),
        tt(npy(u)), n)
    assert np.array_equal(npy(codes).astype(np.int64),
                          np.asarray(rcodes).astype(np.int64))
    assert np.array_equal(npy(dec), np.asarray(rdec))


def test_blocks_cut_and_join():
    mesh_shape = OrderedDict([("pod", 2), ("data", 2), ("model", 2)])
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    spec = ("pod", None, "model")
    assert block_shape(x.shape, spec, mesh_shape) == (2, 6, 4)
    blocks = {}
    for p in range(2):
        for d in range(2):
            for m in range(2):
                c = {"pod": p, "data": d, "model": m}
                blocks[(p, d, m)] = cut_block(x, spec, mesh_shape, c).clone()
    assert torch.equal(blocks[(1, 0, 1)], x[2:, :, 4:])
    assert torch.equal(join_blocks(blocks, spec, mesh_shape), x)


def test_local_mesh_collectives_are_identities():
    mesh = make_mesh((1, 1), ("data", "model"))
    assert not mesh.distributed and mesh.shape == OrderedDict(
        [("data", 1), ("model", 1)])
    x = torch.arange(6, dtype=torch.float32).reshape(1, 6)
    assert mesh.axis_index("model") == 0
    assert mesh.psum(x, ("data", "model")) is x
    assert mesh.pmax(x, "data") is x
    assert torch.equal(mesh.all_gather(x, "data"), x[None])
    assert mesh.gather_leaf(x, ("data", "model")) is x
    assert isinstance(mesh, Mesh)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8"):
        make_mesh((4, 2), ("data", "model"))


class RankMesh(FakeMesh):
    """A mesh's shape seen from the rank at ``coords``."""

    def __init__(self, shape, axes, coords):
        super().__init__(shape, axes)
        self.axis_names = tuple(axes)
        self.distributed = True
        self._coords = dict(zip(axes, coords))

    def axis_index(self, axis):
        return self._coords[axis]

    def coords(self):
        return dict(self._coords)


@pytest.mark.parametrize("transport",
                         ["shard_local", "dequant_psum", "code_allgather"])
def test_exchange_streams_are_each_ranks_own(transport):
    """Each rank of a (4, 2) mesh draws its exchange randomness from
    streams of its own: the shard-local family's model stream is the same
    on every client of a model index and differs across model indices, its
    rank stream differs on every rank; the whole-leaf family's client
    streams are the same on each model rank of a client, and only
    code_allgather (which decodes every client's message) holds them
    all."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import TrainStep
    fed = FedConfig(local_steps=1, bits=8, transport=transport)
    first = {}
    for c in range(4):
        for m in range(2):
            step = TrainStep(get_reduced("llama3.2-1b"), fed,
                             RankMesh((4, 2), ("data", "model"), (c, m)),
                             ShapeConfig("t", 16, 8, "train"),
                             transport=transport, device="cpu")
            st = step.streams
            first[c, m] = {role: torch.rand(8, generator=st[role])
                           for role in st.names}
            if transport == "shard_local":
                assert st.names == {"model": f"model/{m}",
                                    "rank": f"rank/{c}/{m}"}
            else:
                clients = range(4) if transport == "code_allgather" else [c]
                assert st.names == {"server": "server",
                                    **{f"client/{i}": f"client/{i}"
                                       for i in clients}}
    for c in range(4):
        for m in range(2):
            a, b = first[c, m], first[(c + 1) % 4, m]
            if transport == "shard_local":
                assert torch.equal(a["model"], b["model"])
                assert not torch.equal(a["model"], first[c, 1 - m]["model"])
                assert not torch.equal(a["rank"], b["rank"])
                assert not torch.equal(a["rank"], first[c, 1 - m]["rank"])
            else:
                assert torch.equal(a["server"], b["server"])
                own = f"client/{c}"
                assert torch.equal(a[own], first[c, 1 - m][own])
                assert not torch.equal(a[own], b[f"client/{(c + 1) % 4}"])
