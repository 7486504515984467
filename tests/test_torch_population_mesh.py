"""The population store split across ranks (``client_mesh``,
``shard_population``) for every sampling algorithm, and the mesh serving
steps on a (2, 2) mesh, under gloo: one ``torch.multiprocessing.spawn``
of 4 ranks running ``tests/population_ranks_worker.py`` (it imports
neither JAX nor the reference), a ``file://`` rendezvous under
``tmp_path``.

* In-process: ``shard_population`` keeps every row's values and splits
  exactly the rows its docstring names, n/R rows a rank; ``client_mesh()``
  without a process group is the mesh of one; the algorithms without a
  store refuse ``client_mesh``.
* On 4 ranks (n = 16, s = 4, ``gamma_straggler:strength=1``, the
  reference's own resharding test's config): QuAFL eagerly and in 2-round
  chunks, and ``quafl_scaffold``, ``adaptive_quafl``, ``fedavg``,
  ``compressed_fedavg`` and ``fedbuff_device`` for 2 rounds, each rank's
  server, bits and every row ``torch.equal`` to the same run on the whole
  store; the same for ``quafl``, ``quafl_scaffold`` and ``fedbuff_device``
  at n = 18, which the 4 ranks do not divide, so every row stays whole.
* Two split-store QuAFL rounds with the reference's draws injected
  (``tests/test_torch_harness.py``) against the reference's
  ``QuAFL.round`` on one CPU device: bits exactly equal, the server and
  the clients within one lattice step, the last-interaction times equal,
  as ``tests/test_torch_quafl.py`` holds the round. The reference's own
  sharded run is not the oracle: its 8-device test fails under this jax;
  its unsharded run is, since that test asserts the two are bit for bit
  the same.
* The prefill step and 4 serve steps of reduced gemma2-2b, mamba2-370m
  and deepseek-v2-236b on a (2, 2) mesh give the (1, 1) mesh's logits,
  tokens and cache bit for bit (against the reference:
  ``tests/test_torch_serve_steps.py``).
"""
import numpy as np
import jax
import pytest
import torch
import torch.multiprocessing as mp

from population_ranks_worker import (CASES, INJ_BATCH, INJ_FED_KW,
                                     INJ_ROUNDS, RANKS, SERVE_ARCHS,
                                     case_name, run_rank)
from test_torch_harness import npy, reference_round_draws
from repro.configs.base import FedConfig as RefFedConfig
from repro.core.quafl import QuAFL as RefQuAFL
from repro.data import make_federated_classification as ref_data
from repro.data.synthetic import client_batch as ref_client_batch
from repro.models.mlp import init_mlp_classifier as ref_init
from repro.models.mlp import mlp_loss as ref_mlp_loss
from repro_torch.configs.base import FedConfig
from repro_torch.fed import (SplitRow, build_population, client_mesh,
                             make_algorithm, shard_population, whole_row)
from repro_torch.fed.population import WHOLE_ROWS, client_rows
from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched

# the rows each algorithm's store splits over 4 ranks at n = 16
SPLIT = {"quafl": {"model", "last_time", "group"},
         "quafl_scaffold": {"model", "last_time", "group", "control"},
         "adaptive_quafl": {"model", "last_time", "group"},
         "fedavg": {"group"},
         "compressed_fedavg": {"group", "codec_up"},
         "fedbuff_device": {"group", "start"}}


class FakeMesh:
    """A 'clients' axis of ``size`` ranks seen from rank ``rank``: enough
    to split a store (no collective)."""

    def __init__(self, size, rank):
        self.shape = {"clients": size}
        self.rank = rank

    def axis_index(self, name):
        return self.rank


def _store(n):
    fed = FedConfig(n_clients=n, s=4)
    g = torch.Generator()
    g.manual_seed(0)
    rows = dict(model=torch.randn((n, 5), generator=g),
                last_time=torch.rand(n, generator=g),
                control=torch.randn((n, 5), generator=g),
                start=torch.randn((n, 5), generator=g),
                codec_up=torch.randn((n, 5), generator=g),
                occ=torch.arange(n))
    return build_population(fed, n, device="cpu", **rows)


def test_shard_population_splits_the_named_rows():
    pop = _store(16)
    for r in range(4):
        sh = shard_population(pop, FakeMesh(4, r))
        for k, v in pop.rows.items():
            got = sh.rows[k]
            if k in WHOLE_ROWS:
                assert got is v, k
                continue
            assert isinstance(got, SplitRow), k
            assert got.block.shape == (4,) + tuple(v.shape[1:]), k
            assert got.shape == v.shape and got.n == 16
            assert torch.equal(got.block, v[4 * r:4 * r + 4]), k
            # a second split leaves a split row as it is
            assert shard_population(sh, FakeMesh(4, r)).rows[k] is got
    assert set(WHOLE_ROWS) == {"lam", "occ"}
    # a leading dimension that does not divide the axis stays whole
    odd = _store(18)
    sh = shard_population(odd, FakeMesh(4, 1))
    assert all(sh.rows[k] is v for k, v in odd.rows.items())
    # without a process group: the local mesh of one, every value kept
    mesh = client_mesh()
    assert dict(mesh.shape) == {"clients": 1} and not mesh.distributed
    sh = shard_population(pop, mesh)
    for k, v in pop.rows.items():
        assert torch.equal(whole_row(sh.rows[k]), v), k
    no_axis = FakeMesh(1, 0)
    no_axis.shape = {"data": 1}
    with pytest.raises(ValueError, match="clients"):
        shard_population(pop, no_axis)


@pytest.mark.parametrize("n,rank", [(16, None), (18, None), (18, 2),
                                    (1, None), (4, 1)])
def test_a_broadcast_row_gets_memory_of_its_own(n, rank):
    """client_rows' broadcast view (every client's row the same memory)
    comes out of shard_population with memory of its own whenever it is
    not split (mesh None, a leading dimension the axis does not divide,
    a single client): a write to one client's row changes no other and
    not the vector it was made from."""
    x = torch.arange(5, dtype=torch.float32)
    pop = build_population(FedConfig(n_clients=n, s=1), n, device="cpu",
                           model=client_rows(x, n))
    mesh = None if rank is None else FakeMesh(4, rank)
    row = shard_population(pop, mesh).rows["model"]
    split = isinstance(row, SplitRow)
    assert split == (n == 4)
    store, rows = (row.store, row.block) if split else (row, row)
    assert store._base is None and store.is_contiguous()
    assert torch.equal(rows, x[None].expand_as(rows))
    rows[0] = -1.0
    assert torch.equal(rows[0], torch.full((5,), -1.0))
    assert torch.equal(rows[1:], x[None].expand_as(rows[1:]))
    assert torch.equal(x, torch.arange(5, dtype=torch.float32))


def test_algorithms_without_a_store_refuse_client_mesh():
    g = torch.Generator()
    g.manual_seed(0)
    p0 = init_mlp_classifier(g, 16, 32, 4)
    fed = FedConfig(n_clients=8, s=2)
    for name in ("fedbuff", "sequential", "spmd"):
        with pytest.raises(TypeError, match=f"^{name}: .*client_mesh"):
            make_algorithm(name, fed, loss_fn=mlp_loss_batched, template=p0,
                           client_mesh=client_mesh(), device="cpu")


def _reference_injected(out):
    """The reference QuAFL from a warm state, INJ_ROUNDS rounds with their
    draws; the state, data, params and draws written for the ranks.
    Returns each round's reference state."""
    fed = RefFedConfig(**INJ_FED_KW)
    part, _ = ref_data(0, fed.n_clients, d=32, n_classes=10, iid=False)
    params, _ = ref_init(jax.random.PRNGKey(0), 32, 64, 10)
    alg = RefQuAFL(fed=fed, loss_fn=ref_mlp_loss, template=params,
                   batch_fn=lambda d, k: ref_client_batch(k, d, INJ_BATCH))
    state = alg.init(params)
    state, _ = alg.round(state, part, jax.random.PRNGKey(11))
    inp = {"server": npy(state.server), "t": int(state.t),
           "sim_time": float(state.sim_time),
           "bits_up": float(state.bits_up),
           "bits_down": float(state.bits_down),
           "srv_dist_est": npy(state.srv_dist_est)}
    inp.update({f"r/{k}": npy(v) for k, v in state.pop.rows.items()})
    inp.update({f"p/{k}": npy(v) for k, v in params.items()})
    inp.update({f"d/{k}": npy(v) for k, v in part.items()})
    want = []
    for r in range(INJ_ROUNDS):
        key = jax.random.PRNGKey(12 + r)
        draws = reference_round_draws(alg, state, part, key, INJ_BATCH)
        inp.update({f"draw{r}/{k}": v for k, v in draws.items()})
        state, m = alg.round(state, part, key)
        want.append({"server": npy(state.server),
                     "clients": npy(state.clients),
                     "last_time": npy(state.last_time),
                     "bits_up": float(state.bits_up),
                     "bits_down": float(state.bits_down),
                     "m_bits_up": float(m["bits_up"]),
                     "m_bits_down": float(m["bits_down"])})
    np.savez(out / "inj.npz", **inp)
    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("population_ranks")
    want = _reference_injected(out)
    mp.spawn(run_rank, args=(RANKS, str(out)), nprocs=RANKS)
    return want, [torch.load(out / f"port_{r}.pt", weights_only=False)
                  for r in range(RANKS)]


@pytest.mark.parametrize("case", CASES, ids=case_name)
def test_split_store_equals_whole_store(ranks, case):
    _, ports = ranks
    name = case[0]
    for r, port in enumerate(ports):
        assert port["mesh"] == {"clients": RANKS} and port["rank"] == r
        res = port[case_name(case)]
        whole, split = res["whole"], res["split"]
        assert torch.equal(split["server"], whole["server"]), (name, r)
        assert torch.equal(split["server"], ports[0][case_name(case)]
                           ["split"]["server"])
        assert split["bits"] == whole["bits"] and len(split["bits"]) == \
            case[1]
        n = case[4]
        assert split["split"] == ({k: (n // RANKS, n) for k in SPLIT[name]}
                                  if n % RANKS == 0 else {}), (name, r)
        assert not whole["split"]
        assert split["rows"].keys() == whole["rows"].keys()
        for k, v in whole["rows"].items():
            assert torch.equal(split["rows"][k], v), (name, k, r)
        assert split["engine"] == ("scanned" if case[2] else "eager")


def test_split_store_injected_rounds_match_reference(ranks):
    want, ports = ranks
    for port in ports:
        for r, (got, ref) in enumerate(zip(port["injected"], want)):
            for k in ("bits_up", "bits_down", "m_bits_up", "m_bits_down"):
                assert got[k] == ref[k], (r, k)
            # one lattice step: the largest γ either direction used
            for k in ("server", "clients"):
                err = np.abs(npy(got[k]) - ref[k]).max()
                assert err < got["step"], (r, k, err, got["step"])
            np.testing.assert_array_equal(npy(got["last_time"]),
                                          ref["last_time"])
            first = ports[0]["injected"][r]
            for k in ("server", "clients", "last_time"):
                assert torch.equal(got[k], first[k]), (r, k)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_serve_steps_2x2_equal_1x1(ranks, arch):
    _, ports = ranks
    coords = set()
    for port in ports:
        one, grid = port["serve"][arch]["1x1"], port["serve"][arch]["2x2"]
        coords.add(tuple(grid["coords"].values()))
        assert torch.equal(grid["tokens"], one["tokens"]), arch
        assert torch.equal(grid["logits"], one["logits"]), arch
        assert grid["cache"].keys() == one["cache"].keys()
        for k, v in one["cache"].items():
            assert torch.equal(grid["cache"][k], v), (arch, k)
        assert torch.equal(one["tokens"], ports[0]["serve"][arch]["1x1"]
                           ["tokens"])
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
