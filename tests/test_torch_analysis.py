"""The port's ``analysis/`` against the reference's ``repro.analysis`` on
the CPU, and each check against a mutation it must catch.

* Wire marks: for one round of ``quafl×lattice``, ``quafl×lattice_packed``,
  ``quafl×lattice_grouped`` and ``fedavg×topk_ef`` at the lint's tiny
  config, the multiset of (channel, part, codec, container bits, elements
  a message, batched, d) the port records equals the marks of the
  reference's ``RoundEngine.wire_provenance``; for the nine codec ×
  transport exchanges on the abstract (4, 2) mesh, the same but
  ``batched`` (the port's codecs encode a batch of messages, the
  reference's exchange encodes one message a leaf).
* Intervals: the codes interval of the quantize path and the γ-window
  margins over the whole ladder (and the reduce-scatter margins) equal the
  reference's ``interval_of`` on the same functions within relative 1e-6,
  at every bit-width the matrix uses.
* ``list_cells()`` equals the reference's; ``run_lint(quick=True)`` is
  clean on the CPU, and so is a sentinel run.
* Mutations (``tests/test_analysis.py``'s, in the port's terms): a host
  sync, a float64 leak, a draw from the default generator, a 32-bit
  container charged at 8 bits, fp32 on the wire, an undeclared side row,
  an unmarked gather, a γ safety factor that lets the window wrap, a
  rank-dependent value in a replicated output (2 gloo ranks forked from a
  forkserver, ``tests/analysis_ranks_worker.py``), data reallocated every
  chunk, a
  state leaf replaced out of place, a blown rotation budget: each caught,
  the clean version not flagged.
* ``wire_mark`` dispatches no aten op and returns its input; the engine's
  hooks leave the state, the generators and the engine's cache as they
  were; ``lowered_chunk`` refuses on the CPU.
"""
import test_torch_harness  # noqa: F401  (jax.core alias before repro)

import multiprocessing
from collections import Counter

import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from analysis_ranks_worker import run_rank
from repro.analysis import intervals as ref_intervals
from repro.analysis.lint import _build_cell as ref_build_cell
from repro.analysis.lint import _traceable as ref_traceable
from repro.analysis.lint import list_cells as ref_list_cells
from repro.analysis.wire import collect_wire_facts as ref_wire_facts
from repro.compression.pipeline import ExchangePipeline as RefPipeline
from repro.compression.pipeline import LatticeWire as RefWire
from repro.compression.pipeline import coord_bound as ref_coord_bound
from repro.compression.rotation import pad_len as ref_pad_len
from repro.core.exchange_local import rs_gamma as ref_rs_gamma
from repro.fed.engine import RoundEngine as RefEngine
from repro_torch.analysis import intervals, lint
from repro_torch.analysis.donation import audit_engine_chunk
from repro_torch.analysis.jaxpr import (RoundTrace, analyze_round,
                                        check_host_syncs,
                                        check_key_discipline,
                                        check_wide_dtypes, op_counts)
from repro_torch.analysis.opbudget import (check_rotation_budget,
                                           rotation_budget)
from repro_torch.analysis.provenance import WireRecorder, wire_mark
from repro_torch.analysis.sentinel import RecompileSentinel
from repro_torch.analysis.wire import check_wire_truth
from repro_torch.compression.codecs import (GroupedLatticeCodec,
                                            LatticeCodec, WireDecl, WirePart)
from repro_torch.compression.pipeline import ExchangePipeline, LatticeWire
from repro_torch.compression.transports import WireBudget
from repro_torch.fed.engine import (RoundEngine, _leaves, clone_tree,
                                    kernel_nodes)
from repro_torch.launch.mesh import make_abstract_mesh
from test_torch_opbudget import _reference_trace

WIRE_CELLS = (("quafl", "lattice"), ("quafl", "lattice_packed"),
              ("quafl", "lattice_grouped"), ("fedavg", "topk_ef"))
IV_TOL = 1e-6
# the bit-widths the matrix runs: lattice and lattice_packed at b=8, the
# grouped cell's 8/4 members, the exchange's lattice_packed:bits=4
MATRIX_BITS = (8, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny cells gain nothing from intra-op threads, and the suite's
    workers share the machine's cores: one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_key(params, aval):
    shape = tuple(aval.shape)
    size = 1
    for n in shape:
        size *= n
    elems = size // max(shape[0], 1) if params["batched"] and shape \
        else size
    return (params["channel"], params["part"], params["codec"],
            aval.dtype.itemsize * 8, elems, params["batched"], params["d"])


def _port_cell(alg_name, codec):
    alg, data, p0, gen = lint._build_cell(alg_name, codec, "cpu")
    target = lint._traceable(alg)
    return target, target.init(p0), data, gen


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg_name,codec", WIRE_CELLS,
                         ids=[f"{a}x{c}" for a, c in WIRE_CELLS])
def test_wire_marks_equal_reference(alg_name, codec):
    ra, rdata, rp0, rkey = ref_build_cell(alg_name, codec)
    rt = ref_traceable(ra)
    _, marks, _ = RefEngine(rt).wire_provenance(rt.init(rp0), rdata, rkey)
    want = Counter(_ref_key(p, aval) for p, aval, _ in marks)
    target, state, data, gen = _port_cell(alg_name, codec)
    trace, got, _ = RoundEngine(target).wire_provenance(state, data, gen)
    assert Counter(m.key() for m in got) == want
    assert got and all(m.d > 0 for m in got)


@pytest.mark.parametrize("transport", lint.MATRIX_TRANSPORTS)
@pytest.mark.parametrize("codec", lint._EXCHANGE_CODECS)
def test_exchange_marks_equal_reference(codec, transport):
    dn = codec if codec.split(":")[0] in lint._DOWNLINK_OK else ""
    marks, _ = ref_wire_facts(_reference_trace(codec, dn, transport,
                                               lint.EXCHANGE_D,
                                               lint.EXCHANGE_N))
    want = Counter(_ref_key(p, aval)[:5] + _ref_key(p, aval)[6:]
                   for p, aval, _ in marks)
    ex, *_, inputs = lint._exchange(codec, transport, lint.EXCHANGE_D,
                                    lint.EXCHANGE_N, None)
    with RoundTrace() as trace:
        ex(*inputs)
    assert Counter(m.key()[:5] + m.key()[6:] for m in trace.marks) == want
    rep = lint.analyze_exchange_cell(codec, transport)
    assert rep["violations"] == [], rep["violations"]


def _rel(a, b):
    return max(abs(x - y) / max(abs(x), 1e-300) for x, y in zip(a, b))


@pytest.mark.parametrize("bits", MATRIX_BITS)
def test_intervals_equal_reference(bits):
    d = 340   # the lint cell's MLP
    rp = RefPipeline(bits=bits, backend="jnp")
    pp = ExchangePipeline(bits=bits, backend="torch")
    rw = RefWire(bits=bits, pack=1)
    d_pad = ref_pad_len(d, rp.block)
    ex = (jnp.zeros((2, d_pad)), jnp.zeros((2, d_pad)), jnp.zeros((2,)))
    want = ref_intervals.interval_of(
        lambda y, u, g: rp.quantize(y, u, g, rw),
        [(-1e30, 1e30), (0.0, 1.0), (1e-12, 1e30)], *ex)[0]
    got = intervals.encode_codes_interval(pp, LatticeWire(bits), d)
    assert got == (0.0, float(1 << bits)) and _rel(got, want) <= IV_TOL

    def margin(hint, dist, xnorm):
        g = rp.gammas(hint, xnorm, d, rw)
        return (2.0 ** bits) / 2.0 - (ref_coord_bound(dist, d_pad) / g + 1.0)

    one = (jnp.ones(()), jnp.ones(()), jnp.ones(()))
    got = intervals.gamma_window_margins(pp, LatticeWire(bits), d)
    assert len(got) == intervals.LADDER_HI - intervals.LADDER_LO + 1
    for h, m in got:
        want = ref_intervals.interval_of(
            margin, [(h, 2 * h), (0.0, 2 * h), (0.0, 1e30)], *one)[0]
        assert m[0] > 0.0 and _rel(m, want) <= IV_TOL, (h, m, want)


@pytest.mark.parametrize("bits,pack", [(8, 1), (4, 2)])
def test_rs_intervals_equal_reference(bits, pack):
    d, n = lint.EXCHANGE_D, lint.EXCHANGE_N
    rp = RefPipeline(bits=bits, backend="jnp")
    rw = RefWire(bits=bits, pack=pack)
    d_pad = ref_pad_len(d, rp.block)

    def margin(h_sum, dist, nrm):
        g, w = ref_rs_gamma(rp, rw, h_sum, nrm, d)
        return (2.0 ** w.bits) / 2.0 \
            - (ref_coord_bound(dist, d_pad) / g[0] + 1.0)

    one = (jnp.ones(()), jnp.ones(()), jnp.ones(()))
    got = intervals.rs_gamma_window_margins(
        ExchangePipeline(bits=bits, backend="torch"),
        LatticeWire(bits=bits, pack=pack), d, n)
    for h, m in got:
        want = ref_intervals.interval_of(
            margin, [(h, 2 * h), (0.0, 2 * h), (0.0, 1e30)], *one)[0]
        assert m[0] > 0.0 and _rel(m, want) <= IV_TOL, (h, m, want)


def test_cells_equal_reference_and_quick_lint_is_clean(tmp_path):
    assert lint.list_cells() == ref_list_cells()
    timings = {}
    rep = lint.run_lint(quick=True, device="cpu", verbose=False,
                        timings=timings)
    assert rep["violations_total"] == 0, [
        v for sec in ("matrix", "exchange", "sentinel")
        for cell in rep[sec].values() for v in cell["violations"]]
    assert set(rep["matrix"]) | set(rep["exchange"]) | {"rs_transport"} \
        == {c for c in ref_list_cells() if not c.startswith("sentinel:")}
    # the QuAFL round: four marks, the rotation budget, no copy or sync
    q = rep["matrix"]["quaflxlattice"]
    assert q["marks"] == 4
    assert q["rotation_counters"] == rotation_budget(2)
    assert "seconds" not in str(rep) and timings["total"] > 0
    # the CLI writes only where --json says
    out = tmp_path / "lint.json"
    assert lint.main(["--quick", "--device", "cpu", "--only",
                      "sequentialxlattice", "--json", str(out)]) == 0
    assert out.exists()
    with pytest.raises(SystemExit):
        lint.run_lint(quick=True, only="no_such_cell", device="cpu",
                      verbose=False)


def test_sentinel_and_in_place_audit_clean_on_a_run():
    rep = lint.sentinel_run("quafl")
    assert rep["violations"] == [] and rep["programs"] == {"chunk2": 1}
    rep = lint.analyze_cell("fedbuff_device", "lattice", donation=True)
    assert rep["violations"] == []
    d = rep["donation"]
    assert d["steady_chunks"] == 2 and d["leaves_copied"] == 0


# ---------------------------------------------------------------------------
# mutations: each check catches its own
# ---------------------------------------------------------------------------

class Mutant:
    """An algorithm with its ``device_round`` (or ``begin``) changed; every
    other attribute is the wrapped algorithm's."""

    def __init__(self, alg, after=None, begin=None):
        self._alg, self._after, self._begin = alg, after, begin

    def __getattr__(self, name):
        if name == "begin" and self._begin is not None:
            return self._begin
        return getattr(self._alg, name)

    def device_round(self, state, data, generator):
        state, m = self._alg.device_round(state, data, generator)
        if self._after is not None:
            state, m = self._after(state, m, generator)
        return state, m

    round = device_round


def _traced(after):
    target, state, data, gen = _port_cell("quafl", "lattice")
    return (RoundEngine(target).traced_round(state, data, gen),
            RoundEngine(Mutant(target, after)).traced_round(state, data,
                                                           gen))


def test_mutation_host_sync_detected():
    def item(state, m, g):
        m["quant_err"] = float(m["quant_err"])   # a host read
        return state, m
    clean, bad = _traced(item)
    assert check_host_syncs(clean, "ok") == []
    v = check_host_syncs(bad, "fixture")
    assert [x.rule for x in v] == ["host-sync"]
    assert "_local_scalar_dense" in v[0].detail


def test_mutation_float64_leak_detected():
    def f64(state, m, g):
        return state._replace(server=(state.server.double() * 2).float()), m
    clean, bad = _traced(f64)
    assert check_wide_dtypes(clean, "ok") == []
    v = check_wide_dtypes(bad, "fixture")
    assert [x.rule for x in v] == ["wide-dtype"] and "float64" in v[0].detail


def test_mutation_draw_without_generator_detected():
    def draw(state, m, g):
        noise = torch.rand(state.server.shape) * 0.0   # the default stream
        return state._replace(server=state.server + noise), m
    clean, bad = _traced(draw)
    assert check_key_discipline(clean, "ok") == []
    v = check_key_discipline(bad, "fixture")
    assert [x.rule for x in v] == ["key-discipline"] and "rand" in v[0].detail
    viols, rep = analyze_round(bad, "fixture")
    assert {x.rule for x in viols} == {"key-discipline"}
    assert rep["ops_total"] == sum(op_counts(bad).values())


def _mark_trace(fn, *args):
    with RoundTrace() as trace:
        fn(*args)
    return trace


def test_mutation_wide_container_and_fp32_on_the_wire_detected():
    codec = LatticeCodec(bits=8, backend="torch")
    d = 2048
    decl = codec.wire_declaration(d)

    def ships(x, container=None):
        wire_mark(x, channel="up", part="codes", codec=codec.name, d=d,
                  container=container)

    # int32 working codes marked as what ships: a 32-bit container
    # charged at 8 bits a coordinate
    wide = _mark_trace(ships, torch.zeros(d, dtype=torch.int32))
    v = check_wire_truth(wide, where="fixture", decl_up=decl,
                         codec_up=codec, d=d)
    assert len(v) == 1 and "32-bit container" in v[0].detail
    leak = _mark_trace(ships, torch.ones(d))
    v = check_wire_truth(leak, where="fixture", decl_up=decl,
                         codec_up=codec, d=d)
    assert any("fp32 reaching the wire" in x.detail for x in v)
    honest = _mark_trace(ships, torch.zeros(d, dtype=torch.int32),
                         torch.uint8)
    assert check_wire_truth(honest, where="ok", decl_up=decl,
                            codec_up=codec, d=d) == []
    # a declaration that charges 8 bits inside a 32-bit container
    bad = WireDecl(codec.name, (decl.parts[0]._replace(container_bits=32),
                                decl.parts[1]))
    v = check_wire_truth(honest, where="fixture", decl_up=bad)
    assert any("declares a 32-bit container" in x.detail for x in v)


def test_grouped_levels_row_audited_not_exempted():
    codec = GroupedLatticeCodec(bits_per_client=(4, 8),
                                wire_width_per_client=(4, 8),
                                backend="torch")
    d = 1024
    decl = codec.wire_declaration(d)
    assert decl.message_bits == codec.message_bits(d)
    assert decl.moduli == (16, 256)

    def ships():
        wire_mark(torch.zeros((2, d), dtype=torch.int32), channel="up",
                  part="codes", codec="wire", batched=True, d=d,
                  container=torch.uint8)
        wire_mark(torch.zeros(2), channel="up", part="gamma", codec="wire",
                  batched=True, d=d)
        wire_mark(torch.zeros(2), channel="up", part="levels", codec="wire",
                  batched=True, d=d)
    trace = _mark_trace(ships)
    assert check_wire_truth(trace, where="ok", decl_up=decl) == []
    bald = WireDecl(decl.codec, tuple(p for p in decl.parts
                                      if p.part != "levels"),
                    decl.moduli, decl.safety)
    v = check_wire_truth(trace, where="fixture", decl_up=bald)
    assert len(v) == 1 and "side-channel" in v[0].detail


def test_mutation_unmarked_gather_detected():
    """A model-sized fp32 payload gathered with no mark on it is undeclared
    wire traffic; the same payload marked passes."""
    mesh = make_abstract_mesh((4, 2), ("data", "model"))
    budget = WireBudget(caps={"all_gather_fbytes": 1 << 20},
                        float_reduce_ok=False)
    x = torch.empty(4096, device="meta")

    def leak(marked):
        y = x * 1.0
        if marked:
            wire_mark(y, channel="msg", part="vals", codec="topk_ef",
                      d=4096)
        mesh.all_gather(y, "data")
        mesh.psum(y, "data")

    v = check_wire_truth(_mark_trace(leak, False), where="fixture",
                         budget=budget)
    assert sorted(x.detail.split()[0] for x in v) == ["all_gather", "psum"]
    decl = WireDecl("topk_ef", (WirePart("vals", 4096, 32, 4096 * 32,
                                         "float", True),))
    assert check_wire_truth(_mark_trace(leak, True), where="ok",
                            decl_down=decl, budget=budget) == []


def test_mutation_gamma_window_wrap_detected():
    pipe = ExchangePipeline(bits=8, backend="torch")
    wire8 = LatticeWire(bits=8)
    assert intervals.check_encode_intervals(pipe, wire8, 2048, (256,),
                                            "ok") == []
    v = intervals.check_encode_intervals(pipe, wire8, 2048, (16,),
                                         "fixture")
    assert [x.rule for x in v] == ["gamma-overflow"]
    assert intervals.check_gamma_window(pipe, wire8, 2048, "ok") == []
    loose = ExchangePipeline(bits=8, backend="torch", safety=1.5)
    v = intervals.check_gamma_window(loose, wire8, 2048, "fixture")
    assert [x.rule for x in v] == ["gamma-overflow"]
    v = intervals.check_rs_gamma_window(loose, wire8, 1 << 16, 4,
                                        "fixture")
    assert [x.rule for x in v] == ["gamma-overflow"]


def test_mutation_rank_dependent_replicated_output_detected(tmp_path):
    # the ranks forked from a server that imported torch and the worker
    # once (each spawned rank would import them itself)
    multiprocessing.set_forkserver_preload(["torch",
                                            "analysis_ranks_worker"])
    mp.start_processes(run_rank, args=(2, str(tmp_path)), nprocs=2,
                       start_method="forkserver")
    for rank in range(2):
        res = torch.load(tmp_path / f"rank_{rank}.pt")
        assert [v["rule"] for v in res["rank_dependent"]] == [
            "spmd-divergence"], res
        assert "data" in res["rank_dependent"][0]["detail"]
        assert res["resolved"] == res["sharded"] == res["exchange"] == []


def test_mutation_reallocated_data_makes_a_second_program():
    target, state, data, gen = _port_cell("quafl", "lattice")
    s = RecompileSentinel()
    eng = RoundEngine(target)
    st = clone_tree(state)
    for _ in range(3):
        st, _ = eng.run_chunk(st, data, gen, 2)
    assert s.check_engine("ok", eng) == []
    assert eng.chunk_programs() == {2: 1}
    eng = RoundEngine(target)
    st = clone_tree(state)
    for _ in range(3):
        fresh = {k: v.clone() for k, v in data.items()}   # the mutation
        st, _ = eng.run_chunk(st, fresh, gen, 2)
    v = s.check_engine("fixture", eng)
    assert [x.rule for x in v] == ["recompile"] and "3 chunk" in v[0].detail
    # the fingerprint half: another chunk program under one tag
    s2 = RecompileSentinel()
    s2.record("t", RoundEngine(target).traced_chunk(state, data, gen, 2))
    s2.record("t", RoundEngine(target).traced_chunk(state, data, gen, 2))
    assert s2.report() == []
    s2.record("t", RoundEngine(target).traced_chunk(state, data, gen, 3))
    assert [x.rule for x in s2.report()] == ["recompile"]


def test_mutation_state_leaf_replaced_out_of_place_detected():
    target, state, data, gen = _port_cell("quafl", "lattice")
    v, rep = audit_engine_chunk(RoundEngine(target), state, data, gen, 2,
                                "ok")
    assert v == [] and rep["per_chunk"] == [[0, 0], [0, 0]]
    assert rep["leaves_copied"] == rep["bytes_copied"] == 0

    def begin(st, g):
        return st._replace(server=st.server.clone())   # the mutation
    v, rep = audit_engine_chunk(RoundEngine(Mutant(target, begin=begin)),
                                state, data, gen, 2, "fixture")
    assert [x.rule for x in v] == ["in-place"]
    assert rep["leaves_copied"] == 2
    assert rep["bytes_copied"] == 2 * state.server.numel() * 4


def test_mutation_blown_rotation_budget_detected():
    target, state, data, gen = _port_cell("quafl", "lattice")
    assert check_rotation_budget(target, state, data, gen, "ok") == []

    def extra(st, m, g):   # one rotation pass the budget does not allow
        target.pipeline.rotate(st.server[None], torch.ones(512))
        return st, m
    v = check_rotation_budget(Mutant(target, extra), state, data, gen,
                              "fixture")
    assert [x.rule for x in v] == ["op-budget"]
    assert "rotation_fwd" in v[0].detail


# ---------------------------------------------------------------------------
# the marks cost nothing; the hooks move nothing
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_wire_mark_dispatches_nothing_and_returns_its_input():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    for recording in (False, True):
        with _Ops() as ops:
            if recording:
                with WireRecorder() as rec:
                    y = wire_mark(x, channel="up", part="codes",
                                  codec="wire", batched=True, d=3,
                                  container=torch.uint8)
            else:
                y = wire_mark(x, channel="up", part="codes", codec="wire")
        assert y is x and ops.names == []
    assert rec.marks[0].key() == ("up", "codes", "wire", 8, 3, True, 3)
    # a whole round: the recorder's op log and a bare op log list the same
    # ops, so the marks add none, recorder or not
    target, state, data, gen = _port_cell("quafl", "lattice")
    copy, g = clone_tree(state), _copy_generator(gen)
    with _Ops() as ops:
        target.device_round(copy, data, g)
    trace = RoundEngine(target).traced_round(state, data, gen)
    assert ops.names == [op.name for op in trace.ops
                         if op.name not in _KERNELS]
    assert len(trace.marks) == 4


_KERNELS = {"fused_encode", "fused_rotate", "quantize_codes", "snap_codes",
            "fused_decode", "uplink", "average"}


def _copy_generator(gen):
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


@pytest.mark.parametrize("alg_name", ["quafl", "fedbuff_device", "spmd"])
def test_hooks_leave_state_generators_and_cache(alg_name):
    target, state, data, gen = _port_cell(alg_name, "lattice")
    before = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in _leaves(state)]
    ids = [id(x) for x in _leaves(state)]
    own = tuple(getattr(target, "generators", tuple)())
    g0 = [g.get_state() for g in (gen,) + own]
    eng = RoundEngine(target)
    # traced_round and wire_provenance are traced_chunk of one round
    trace = eng.traced_chunk(state, data, gen, 2)
    assert trace.ops and trace.marks
    assert [id(x) for x in _leaves(state)] == ids
    for a, b in zip(_leaves(state), before):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    for g, s in zip((gen,) + own, g0):
        assert torch.equal(g.get_state(), s)
    assert eng.chunk_programs() == {} and eng.copies == []
    with pytest.raises(RuntimeError, match="no graph is captured"):
        eng.lowered_chunk(state, data, gen, 2)


# two nodes of a captured QuAFL round's debug dump on the H100
# (cudaGraphDebugDotPrint, verbose), names shortened
_DOT = """digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_246"[style="bold" shape="record" label="{KERNEL
| {ID | 246 (topoId: 61) | _ZN2at6native18elementwise_kernelILi128E\\<\\<\\<1591,128,0\\>\\>\\>}
| {{node handle | func handle} | {0x00007FDEA91DAF00 | 0x000000000EF3A550}}
| {cooperative | 0}
}"];

"graph_1_node_247"[style="bold" shape="record" label="{KERNEL
| {ID | 247 (topoId: 60) | _ZN44_GLOBAL__N__311403b3_11_exchange_cu_9aac226421encode_cluster_kernelILi8EEEvPKfS2_\\<\\<\\<\\{16,16\\},256,8192\\>\\>\\>}
| {cooperative | 0}
}"];

"graph_1_node_248"[style="solid" shape="rectangle" label="MEMSET"];
"graph_1_node_246" -> "graph_1_node_247";
}
}
"""


def test_kernel_nodes_of_a_graph_dump():
    nodes = kernel_nodes(_DOT)
    assert len(nodes) == 2
    assert ["encode_cluster_kernel" in n for n in nodes] == [False, True]
