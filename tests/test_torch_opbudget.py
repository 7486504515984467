"""The port's ``analysis/opbudget.py`` against the reference's
``repro.analysis.opbudget`` on the CPU.

* the rotation counters one round increments, for every registry algorithm
  at the quickstart size (``examples/quickstart.py``'s FedConfig, batch
  32, its data and weights on both sides), equal the reference's ``measure_round_counters`` exactly, and
  ``check_rotation_budget`` gives the reference's findings (``[]`` for the
  algorithms whose round runs the counted pipeline; the reference's two for
  ``quafl_scaffold``, whose SCAFFOLD exchange runs per-message codec
  encodes and leaves its inherited pipeline at zero); neither the caller's
  state nor its generator moves;
* a budget one pass off gives exactly one violation;
* the shard-local exchange of each codec × transport of the reference's
  lint matrix on an abstract (4, 2) mesh (d = 2^16, n = 4, leaves split
  over 'model', as ``repro/analysis/lint.py``'s ``_trace_exchange``) moves
  per device what the transport's ``wire_budget`` allows, and exactly the
  reference's ``collective_bytes`` per key; a cap one byte under what was
  measured gives exactly one violation. (``_trace_exchange`` builds its
  ``AbstractMesh`` with jax 0.4's signature; :func:`_reference_trace` is
  its body with jax 0.9's.)
"""
import test_torch_harness  # noqa: F401  (jax.core alias before repro)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.jaxpr import collective_bytes as ref_collective_bytes
from repro.analysis.opbudget import \
    check_rotation_budget as ref_check_rotation_budget
from repro.analysis.opbudget import \
    measure_round_counters as ref_measure_round_counters
from repro.configs.base import FedConfig as RefFedConfig
from repro.data.synthetic import client_batch as ref_client_batch
from repro.fed import make_algorithm as ref_make_algorithm
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.analysis.opbudget import (ROT_FWD, ROT_INV, OpBudget,
                                           check_collective_bytes,
                                           check_rotation_budget,
                                           collective_bytes,
                                           measure_round_counters,
                                           op_budget_report, rotation_budget)
from repro_torch.analysis.violation import Violation
from repro_torch.compression.codecs import resolve_codec
from repro_torch.compression.transports import make_transport
from repro_torch.configs.base import FedConfig
from repro_torch.core.exchange_local import make_shardlocal_exchange
from repro_torch.examples import quickstart
from repro_torch.fed import make_algorithm
from repro_torch.fed.engine import _leaves, clone_tree
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.steps import ExchangeStreams
from repro_torch.models.mlp import mlp_loss_batched

# every registry algorithm but spmd, which needs an LM config
ALGORITHMS = ("quafl", "fedavg", "fedbuff", "sequential", "quafl_scaffold",
              "adaptive_quafl", "fedbuff_device", "compressed_fedavg")
# the reference's lint matrix (repro/analysis/lint.py:60-61)
CODECS = ("lattice:bits=8", "lattice_packed:bits=4", "topk_ef")
TRANSPORTS = ("shard_local", "code_allgather", "reduce_scatter")
EX_D, EX_N = 1 << 16, 4


@pytest.fixture(scope="module")
def quick():
    """The quickstart world, reference and port side."""
    dev = torch.device("cpu")
    p0, part, _ = quickstart.setup(dev)
    fed = quickstart.FED
    rfed = RefFedConfig(n_clients=16, s=4, local_steps=5, lr=0.3, bits=8,
                        swt=10.0, quantizer="lattice")
    # the same data and weights on the reference's side
    rpart = {"x": jnp.asarray(part["x"].numpy()),
             "y": jnp.asarray(part["y"].numpy().astype(np.int32))}
    rp0 = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
    return fed, p0, part, rfed, rp0, rpart


def _port(name, quick, **kw):
    fed, p0, part = quick[:3]
    alg = make_algorithm(name, fed, loss_fn=mlp_loss_batched, template=p0,
                         batch_size=32, device="cpu", **kw)
    return alg, alg.init(p0), part


def test_opbudget_counters_and_legacy_surface():
    b = OpBudget()
    b.fwd += 3
    b.inv = 2
    b.add("extra", 4)
    b.add("extra")
    assert (b.fwd, b.inv, b.get("extra"), b.get("none")) == (3, 2, 5, 0)
    assert b.counts() == {ROT_FWD: 3, ROT_INV: 2}
    assert b.expect("w", {ROT_FWD: 3, ROT_INV: 2, "extra": 5}) == []
    b.reset()
    assert b.counters == {} and b.fwd == 0
    assert rotation_budget(16) == {ROT_FWD: 17, ROT_INV: 17}
    v = Violation("op-budget", "here", "why")
    assert v.as_dict() == {"rule": "op-budget", "where": "here",
                           "detail": "why"}


@pytest.mark.parametrize("name", ALGORITHMS)
def test_round_counters_and_findings_match_reference(name, quick):
    rfed, rp0, rpart = quick[3:]
    ref = ref_make_algorithm(name, rfed, loss_fn=ref_mlp_loss,
                             template=rp0,
                             batch_fn=lambda d, k: ref_client_batch(k, d,
                                                                    32),
                             **({"buffer_size": 4}
                                if name == "fedbuff_device" else {}))
    rst = ref.init(rp0)
    key = jax.random.PRNGKey(1)
    want = ref_measure_round_counters(ref, rst, rpart, key)
    want_v = ref_check_rotation_budget(ref, rst, rpart, key, name)

    alg, st, part = _port(name, quick, **({"buffer_size": 4}
                                          if name == "fedbuff_device"
                                          else {}))
    gen = torch.Generator().manual_seed(1)
    g0 = gen.get_state().clone()
    before = clone_tree(st)
    got = measure_round_counters(alg, st, part, gen)
    assert (None if got is None else got.counters) == (
        None if want is None else want.counters)
    got_v = check_rotation_budget(alg, st, part, gen, name)
    assert [v.as_dict() for v in got_v] == [v.as_dict() for v in want_v]
    if name != "quafl_scaffold":
        assert got_v == []
    # neither the caller's state nor its generator moved
    assert torch.equal(gen.get_state(), g0)
    for a, b in zip(_leaves(st), _leaves(before)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


def test_grouped_quafl_and_a_wrong_budget(quick):
    """The grouped uplink keeps the s + 1 / s + 1 contract; a budget one
    pass off gives exactly one violation, naming the counter."""
    alg, st, part = _port("quafl", quick,
                          uplink={"fast": "lattice",
                                  "slow": "lattice_packed:bits=4"})
    gen = torch.Generator().manual_seed(3)
    assert check_rotation_budget(alg, st, part, gen, "grouped") == []
    s = quick[0].s
    v = check_rotation_budget(alg, st, part, gen, "grouped",
                              budget={ROT_FWD: s + 1, ROT_INV: s})
    assert len(v) == 1 and v[0].rule == "op-budget"
    assert "rotation_inv" in v[0].detail


def test_op_budget_report_merges_walker_and_counters(quick):
    alg, st, part = _port("quafl", quick)
    gen = torch.Generator().manual_seed(1)
    rep = op_budget_report(alg, st, part, gen)
    s = quick[0].s
    assert rep[ROT_FWD] == rep[ROT_INV] == s + 1
    assert rep["ops_total"] > 0
    # the kernels of the exchange, one record a call
    assert rep["fused_encode"] == 1 and rep["fused_rotate"] >= 1
    fa, fst, fpart = _port("fedavg", quick)
    frep = op_budget_report(fa, fst, fpart, gen)
    assert ROT_FWD not in frep and frep["ops_total"] > 0


def _reference_trace(codec_up: str, codec_dn: str, transport_name: str,
                     d: int, n: int):
    """``repro.analysis.lint._trace_exchange`` (model-sharded leaves) with
    jax 0.9's ``AbstractMesh(axis_sizes, axis_names)``."""
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from repro.compression.codecs import resolve_codec as ref_resolve
    from repro.compression.transports import make_transport as ref_tr
    from repro.core.exchange_local import \
        make_shardlocal_exchange as ref_exchange
    mesh = AbstractMesh((n, 2), ("data", "model"))
    fed = RefFedConfig(n_clients=n, s=n, bits=8, codec_up=codec_up,
                       codec_down=codec_dn)
    up = ref_resolve(None, fed, direction="up")
    dn = ref_resolve(None, fed, direction="down")
    ex = ref_exchange(up, dn, mesh, {"w": P("model")},
                      {"w": P("data", "model")}, "data", n,
                      transport=ref_tr(transport_name))
    srv = {"w": jax.ShapeDtypeStruct((d,), jnp.float32)}
    cl = {"w": jax.ShapeDtypeStruct((n, d), jnp.float32)}
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return jax.make_jaxpr(ex)(srv, cl, cl, key)


def _port_exchange_records(codec: str, transport: str):
    dn_spec = codec if codec.split(":")[0] in ("lattice",
                                               "lattice_packed") else ""
    fed = FedConfig(n_clients=EX_N, s=EX_N, bits=8, codec_up=codec,
                    codec_down=dn_spec)
    up = resolve_codec(None, fed, direction="up")
    dn = resolve_codec(None, fed, direction="down")
    tr = make_transport(transport)
    mesh = make_abstract_mesh((EX_N, 2), ("data", "model"))
    ex = make_shardlocal_exchange(up, dn, mesh, "data", EX_N, tr)
    blk = EX_D // 2
    meta = dict(device="meta", dtype=torch.float32)
    server = {"w": torch.empty((blk,), **meta)}
    clients = {"w": torch.empty((1, blk), **meta)}
    ys = {"w": torch.empty((1, blk), **meta)}
    streams = ExchangeStreams(0, {"model": "model/0", "rank": "rank/0/0"},
                              "meta")
    with mesh.recording() as records:
        ex(server, clients, ys, streams)
    return list(records), tr.wire_budget(up, dn, EX_D, EX_N)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("codec", CODECS)
def test_collective_bytes_within_budget_and_equal_reference(codec,
                                                            transport):
    records, budget = _port_exchange_records(codec, transport)
    assert all(r["out_bytes"] >= 0 for r in records) and records
    where = f"exchange:{codec.split(':')[0]}x{transport}"
    assert check_collective_bytes(records, where, budget.caps) == []
    dn_spec = codec if codec.split(":")[0] in ("lattice",
                                               "lattice_packed") else ""
    closed = _reference_trace(codec, dn_spec, transport, EX_D, EX_N)
    assert collective_bytes(records) == ref_collective_bytes(closed)
    # a cap one byte under what was measured is caught, alone
    key, got = max(collective_bytes(records).items(), key=lambda kv: kv[1])
    caps = dict(budget.caps, **{key: got - 1})
    v = check_collective_bytes(records, where, caps)
    assert len(v) == 1 and v[0].rule == "collective-bytes"
    assert key in v[0].detail
