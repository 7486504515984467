"""``python -m repro_torch.analysis.lint`` — the port's invariant gate (port
of ``repro.analysis.lint``).

    python -m repro_torch.analysis.lint [--quick] [--only CELL]
                                        [--json PATH] [--device cuda|cpu]
                                        [--list]

Runs every check of :mod:`repro_torch.analysis` and prints its report:

* **the round matrix** — every registry algorithm but the host-driven
  ``fedbuff``, with each uplink codec of ``MATRIX_CODECS`` (and QuAFL's
  heterogeneous ``lattice_grouped``), built at a tiny config on the
  device; its round's op log (``RoundEngine.traced_round``) and a 2-round
  chunk's (``traced_chunk``) checked for host syncs, 64-bit values and
  draws from the default generator; the round's wire marks against the
  codecs' declarations; the γ intervals of each lattice direction at each
  of its bit-widths; the rotation budget; unless ``--quick``, the in-place
  audit of a few chunks (captured as CUDA graphs on the card);
* **the exchange matrix** — each codec × transport of the shard-local
  exchange on the abstract (4, 2) data×model mesh on ``meta``: wire truth
  with the transport's ``WireBudget`` (every gathered payload marked, each
  collective class under its cap) and the reduce-scatter γ_rs wrap proof;
  given a mesh of ranks (``run_lint(mesh=...)``), the same exchange on
  real tensors over it, its replicated outputs held equal across ranks;
* **AST rules** over ``src/repro_torch/`` (``analysis/astlint.py``);
* **rs_transport** — the fused reduce-scatter exchange's collective bytes
  on the replicated layout, under its transport's caps;
* **sentinels** (unless ``--quick``) — a ``simulate(scan_chunk=2)`` run of
  each algorithm: one chunk program a length, the chunk's op log the same
  before and after the run, nothing copied into a chunk in steady state.

Its cells are the reference's (:func:`list_cells`). The exit status is the
number of violations (0 = clean, at most 125). The report is written only
where ``--json`` says; the reference's ``ANALYSIS.json`` stays the
reference's. The checks run on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

# algorithm × codec matrix ---------------------------------------------------

MATRIX_CODECS = ("lattice", "lattice_packed", "topk_ef")

# codec × transport exchange matrix
MATRIX_TRANSPORTS = ("shard_local", "code_allgather", "reduce_scatter")
_EXCHANGE_CODECS = ("lattice:bits=8", "lattice_packed:bits=4", "topk_ef")

# per-algorithm construction kwargs at the tiny config
_ALG_KWARGS = {"fedbuff_device": {"buffer_size": 2}}

# the lattice families also run the downlink direction
_DOWNLINK_OK = ("lattice", "lattice_packed")

EXCHANGE_D, EXCHANGE_N = 1 << 16, 4


def _cells(only: Optional[str] = None):
    from repro_torch.fed.registry import registered_algorithms
    for alg in registered_algorithms():
        if alg == "fedbuff":
            continue
        codecs = MATRIX_CODECS
        if alg == "quafl":
            # heterogeneous per-client widths: the batched exchange with a
            # levels row, the side channel the wire audit must see
            codecs = codecs + ("lattice_grouped",)
        for codec in codecs:
            if only and only not in f"{alg}x{codec}":
                continue
            yield alg, codec


def _exchange_cell_name(codec: str, transport: str) -> str:
    return f"exchange:{codec.split(':')[0]}x{transport}"


def _exchange_cells(only: Optional[str] = None):
    for codec in _EXCHANGE_CODECS:
        for transport in MATRIX_TRANSPORTS:
            if only and only not in _exchange_cell_name(codec, transport):
                continue
            yield codec, transport


def list_cells() -> List[str]:
    """Every cell name the full gate runs (the ``--list`` surface)."""
    names = [f"{a}x{c}" for a, c in _cells()]
    names += [_exchange_cell_name(c, t) for c, t in _exchange_cells()]
    names += ["rs_transport"]
    names += [f"sentinel:{a}" for a, c in _cells() if c == "lattice"]
    return names


def _build_cell(alg_name: str, codec: str, device):
    """(alg, data, params0, generator) at the tiny config on ``device``."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.fed.registry import make_algorithm
    device = torch.device(device)
    kw = dict(_ALG_KWARGS.get(alg_name, {}))
    if codec == "lattice_grouped":
        # the group map resolves over the clock's straggler mask into ONE
        # GroupedLatticeCodec (mixed 8/4-bit member widths)
        kw["uplink"] = {"fast": "lattice", "slow": "lattice:bits=4"}
        codec, down = "", ""
    else:
        down = codec if codec.split(":")[0] in _DOWNLINK_OK else ""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    if alg_name == "spmd":
        from repro_torch.configs import get_reduced
        from repro_torch.data.synthetic import federated_token_task
        from repro_torch.models.model import init_lm
        cfg = get_reduced("llama3.2-1b")
        fed = FedConfig(n_clients=1, s=1, local_steps=1, lr=0.02,
                        codec_up=codec, codec_down=down)
        params0, _ = init_lm(cfg, seed=0, device=device)
        data, _ = federated_token_task(0, 1, 32, 2, 16, cfg.vocab_size,
                                       device=device)
        alg = make_algorithm("spmd", fed, loss_fn=None, template=params0,
                             cfg=cfg, batch=2, seq=16, device=device, **kw)
        return alg, data, params0, gen
    from repro_torch.data.synthetic import make_federated_classification
    from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched
    d, hidden, classes = 16, 16, 4
    fed = FedConfig(n_clients=4, s=2, local_steps=1, lr=0.2, bits=8,
                    codec_up=codec, codec_down=down)
    part, _ = make_federated_classification(0, fed.n_clients, d=d,
                                            n_classes=classes, device=device)
    g0 = torch.Generator(device=device)
    g0.manual_seed(0)
    params0 = init_mlp_classifier(g0, d, hidden, classes)
    alg = make_algorithm(alg_name, fed, loss_fn=mlp_loss_batched,
                         template=params0, batch_size=16, device=device,
                         **kw)
    return alg, part, params0, gen


def _traceable(alg):
    """The algorithm whose ``device_round`` the hooks log. One with host
    control between chunks (the adaptive walk's ``scan_rounds``) is
    analysed through its current width's inner algorithm."""
    inner_of = getattr(alg, "_alg", None)
    if callable(getattr(alg, "scan_rounds", None)) and callable(inner_of):
        return inner_of(int(alg.fed.bits))
    return alg


def _codec_pipe(codec):
    """An ``ExchangePipeline`` with the codec's own γ derivation (bits,
    block, safety) on the plain backend: the interval checks trace it."""
    from repro_torch.compression.pipeline import ExchangePipeline
    return ExchangePipeline(bits=int(codec.bits), block=codec.block,
                            backend="torch", safety=float(codec.safety))


def _decl(codec, d: int):
    return (codec.wire_declaration(d)
            if hasattr(codec, "wire_declaration") else None)


def flow_checks(trace, target, d: int, where: str) -> List:
    """Wire truth on one round's op log against ``target``'s own resolved
    codecs at the model dimension ``d``, and the γ intervals of each
    lattice direction, member by member for a grouped codec."""
    from repro_torch.analysis.intervals import (check_encode_intervals,
                                                check_gamma_window)
    from repro_torch.analysis.wire import check_wire_truth
    from repro_torch.compression.codecs import resolve_codec
    from repro_torch.compression.pipeline import LatticeWire
    fed = target.fed
    up = getattr(target, "codec_up", None)
    dn = getattr(target, "codec_down", None)
    up = up if up is not None else resolve_codec(None, fed, direction="up")
    dn = dn if dn is not None else resolve_codec(None, fed,
                                                 direction="down")
    viols = check_wire_truth(trace, where=where, decl_up=_decl(up, d),
                             decl_down=_decl(dn, d), codec_up=up,
                             codec_down=dn, d=d)
    for direction, codec in (("up", up), ("down", dn)):
        if getattr(codec, "family", "") != "lattice":
            continue
        pipe = _codec_pipe(codec)
        member_bits = sorted(set(getattr(codec, "bits_per_client",
                                         (int(codec.bits),))))
        for b in member_bits:
            # the unpacked uniform wire: packing relayouts in-range codes,
            # and γ and the wrap are functions of the bit-width alone
            wire = LatticeWire(bits=int(b), pack=1)
            tag = (f"{where}/{direction}" if len(member_bits) == 1
                   else f"{where}/{direction}@bits{b}")
            viols += check_encode_intervals(pipe, wire, d, (1 << int(b),),
                                            tag)
            viols += check_gamma_window(pipe, wire, d, tag)
    return viols


def analyze_cell(alg_name: str, codec: str, *, device="cpu",
                 donation: bool = True, chunk: int = 2) -> Dict:
    """Every check of one (algorithm, codec) cell."""
    from repro_torch.analysis.donation import audit_engine_chunk
    from repro_torch.analysis.jaxpr import analyze_round
    from repro_torch.analysis.opbudget import (measure_round_counters,
                                               rotation_budget)
    from repro_torch.fed.engine import RoundEngine, _tensor_leaves
    cell = f"{alg_name}x{codec}"
    alg, data, params0, gen = _build_cell(alg_name, codec, device)
    target = _traceable(alg)
    state = target.init(params0)
    eng = RoundEngine(target)
    trace_r = eng.traced_round(state, data, gen)
    viols, ops = analyze_round(trace_r, f"{cell}/round")
    model_dim = sum(x.numel() for x in _tensor_leaves(params0))
    viols += flow_checks(trace_r, target, model_dim, f"{cell}/round")
    vs, ops_chunk = analyze_round(eng.traced_chunk(state, data, gen, chunk),
                                  f"{cell}/chunk{chunk}")
    viols += vs
    report: Dict = {"ops_round": ops, "ops_chunk": ops_chunk,
                    "marks": len(trace_r.marks)}
    measured = measure_round_counters(target, state, data, gen)
    if measured is not None:
        report["rotation_counters"] = dict(measured.counters)
        # the s+1 / s+1 budget binds the rounds that run the rotated
        # exchange; an inherited pipeline a round leaves unused counts 0
        if any(measured.counters.values()):
            viols += measured.expect(f"{cell}/round",
                                     rotation_budget(int(target.fed.s)))
    if donation:
        vs, report["donation"] = audit_engine_chunk(
            eng, state, data, gen, chunk, f"{cell}/chunk{chunk}")
        viols += vs
    report["violations"] = [v.as_dict() for v in viols]
    return report


def _exchange(codec: str, transport_name: str, d: int, n: int, mesh,
              model_sharded: bool = True):
    """The shard-local exchange of one codec × transport over ``mesh``
    (the abstract (n, 2) data×model mesh when None, on ``meta``): returns
    (exchange, up, dn, transport, inputs)."""
    from repro_torch.compression.codecs import resolve_codec
    from repro_torch.compression.transports import make_transport
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.exchange_local import make_shardlocal_exchange
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.steps import ExchangeStreams
    dn_spec = codec if codec.split(":")[0] in _DOWNLINK_OK else ""
    device = "meta"
    if mesh is None:
        mesh = make_abstract_mesh((n, 2), ("data", "model"))
    else:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    fed = FedConfig(n_clients=n_data, s=n_data, bits=8, codec_up=codec,
                    codec_down=dn_spec)
    up = resolve_codec(None, fed, direction="up")
    dn = resolve_codec(None, fed, direction="down")
    tr = make_transport(transport_name)
    ex = make_shardlocal_exchange(up, dn, mesh, "data", n_data, tr)
    blk = d // n_model if model_sharded else d
    coords = mesh.coords()
    streams = ExchangeStreams(0, {"model": f"model/{coords['model']}",
                                  "rank": f"rank/{coords['data']}/"
                                          f"{coords['model']}"}, device)
    if device == "meta":
        mk = dict(device="meta", dtype=torch.float32)
        inputs = ({"w": torch.empty((blk,), **mk)},
                  {"w": torch.empty((1, blk), **mk)},
                  {"w": torch.empty((1, blk), **mk)}, streams)
    else:
        g = torch.Generator(device=device)
        g.manual_seed(7)   # the same server on every rank
        server = torch.randn((blk,), generator=g, device=device)
        g.manual_seed(100 + coords["data"])   # each client its own model
        ys = server + 0.01 * torch.randn((1, blk), generator=g,
                                         device=device)
        inputs = ({"w": server}, {"w": ys.clone()}, {"w": ys}, streams)
    return ex, up, dn, tr, inputs


def analyze_exchange_cell(codec: str, transport_name: str,
                          d: int = EXCHANGE_D, n: int = EXCHANGE_N,
                          mesh=None) -> Dict:
    """Wire truth, the byte budget and the γ_rs wrap proof of one codec ×
    transport on the abstract mesh; given ``mesh`` (a mesh of ranks), the
    exchange also runs on real tensors over it and its replicated outputs
    are held equal across ranks (every rank must call it)."""
    from repro_torch.analysis.divergence import check_divergence
    from repro_torch.analysis.intervals import check_rs_gamma_window
    from repro_torch.analysis.jaxpr import RoundTrace, op_report
    from repro_torch.analysis.wire import check_wire_truth
    cell = _exchange_cell_name(codec, transport_name)
    ex, up, dn, tr, inputs = _exchange(codec, transport_name, d, n, None)
    with RoundTrace() as trace:
        ex(*inputs)
    budget = tr.wire_budget(up, dn, d, n)
    d_leaf = d + (-d) % 1024   # the exchange pads leaves to 1024 multiples
    viols = check_wire_truth(trace, where=cell, decl_up=_decl(up, d_leaf),
                             decl_down=_decl(dn, d_leaf), codec_up=up,
                             codec_down=dn, d=d_leaf, budget=budget)
    if transport_name == "reduce_scatter" \
            and getattr(dn, "family", "") == "lattice":
        viols += check_rs_gamma_window(_codec_pipe(dn), dn.wire(), d_leaf,
                                       n, cell)
    rep = {"ops": op_report(trace), "marks": len(trace.marks)}
    if mesh is not None:
        ex_r, _, _, _, inputs_r = _exchange(codec, transport_name, d, n,
                                            mesh)
        server, clients, qerr = ex_r(*inputs_r)
        outs = {"server": server["w"], "clients": clients["w"],
                "qerr": qerr}
        specs = {"server": ("model",), "clients": ("data", "model"),
                 "qerr": None}
        viols += check_divergence(outs, specs, mesh, f"{cell}@ranks")
        rep["ranks"] = dict(mesh.shape)
    rep["violations"] = [v.as_dict() for v in viols]
    return rep


def sentinel_run(alg_name: str, *, device="cpu", rounds: int = 4,
                 chunk: int = 2, codec: str = "lattice") -> Dict:
    """One program a chunk length on a real ``simulate(scan_chunk=chunk)``
    run: the chunk's op log pinned before the run and again after it, the
    engine's programs counted, and its steady-state chunks audited for
    copies."""
    from repro_torch.analysis.donation import audit_engine
    from repro_torch.analysis.sentinel import RecompileSentinel
    from repro_torch.fed.engine import RoundEngine
    from repro_torch.fed.simulate import simulate
    alg, data, params0, gen = _build_cell(alg_name, codec, device)
    target = _traceable(alg)
    sentinel = RecompileSentinel()
    tag = f"{alg_name}x{codec}"
    pre = RoundEngine(target).traced_chunk(target.init(params0), data, gen,
                                           chunk)
    sentinel.record((tag, chunk), pre)
    run_gen = torch.Generator(device=gen.device)
    run_gen.manual_seed(2)
    simulate(alg, params0, data, run_gen, rounds=rounds, eval_every=0,
             scan_chunk=chunk)
    engines = [("", e) for e in [getattr(alg, "_round_engine", None)]
               if e is not None]
    # the adaptive wrapper runs one engine a visited bit-width: the same
    # one-program contract, a tag a width (the starting width's is bare)
    engines += [("" if b == int(alg.fed.bits) else f"@bits{b}", e)
                for b, e in getattr(alg, "_engines", {}).items()]
    viols, programs = [], {}
    for subtag, eng in engines:
        sentinel.check_engine((tag + subtag, chunk), eng)
        if not callable(getattr(eng.alg, "device_round", None)):
            continue   # the adaptive wrapper's own engine runs no chunk
        post = eng.traced_chunk(eng.alg.init(params0), data, gen, chunk)
        sentinel.record((tag + subtag, chunk), post)
        for length, n in eng.chunk_programs().items():
            programs[f"chunk{length}{subtag}"] = n
        if eng.alg is alg:
            viols += audit_engine(eng, f"{tag}/chunk{chunk}")
    viols += sentinel.report()
    return {"violations": [v.as_dict() for v in viols],
            "programs": programs}


def rs_transport_audit(d: int = EXCHANGE_D, n: int = EXCHANGE_N) -> Dict:
    """The fused ``reduce_scatter`` exchange (``lattice_packed:bits=4``
    both ways) on the replicated layout of the abstract (4, 2) mesh: the
    op-log checks and its collective bytes under its transport's caps —
    the redistribution gathers integer codes and scalar γ rows, never fp32,
    and no full-size fp32 psum comes back."""
    from repro_torch.analysis.jaxpr import RoundTrace, analyze_round
    from repro_torch.analysis.opbudget import check_collective_bytes
    ex, up, dn, tr, inputs = _exchange(
        "lattice_packed:bits=4", "reduce_scatter", d, n, None,
        model_sharded=False)
    with RoundTrace() as trace:
        ex(*inputs)
    where = "shard_local_rs/exchange@mesh(4,2)"
    viols, ops = analyze_round(trace, where)
    viols += check_collective_bytes([r for r, _ in trace.collectives],
                                    where, tr.wire_budget(up, dn, d,
                                                          n).caps)
    return {"ops": ops, "violations": [v.as_dict() for v in viols]}


def run_lint(*, quick: bool = False, only: Optional[str] = None,
             device=None, mesh=None, donation: Optional[bool] = None,
             sentinel: Optional[bool] = None, verbose: bool = True,
             timings: Optional[Dict[str, float]] = None) -> Dict:
    """The gate: AST rules, the round matrix, the exchange matrix,
    rs_transport (and the in-place audits and sentinels unless
    ``quick``), on ``device`` (default: the card). Returns the report;
    wall seconds go to ``timings`` (cell -> seconds), never the report. An
    ``only`` that matches no cell raises ``SystemExit`` listing them."""
    from repro_torch import default_device
    from repro_torch.analysis.astlint import lint_path
    device = default_device(device)
    donation = (not quick) if donation is None else donation
    sentinel = (not quick) if sentinel is None else sentinel
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    if only is not None and not any(only in name for name in list_cells()):
        raise SystemExit(
            f"--only {only!r} matches no analysis cell; known cells:\n  "
            + "\n  ".join(list_cells()))
    src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ast_viols = lint_path(src_root)
    n_viols = len(ast_viols)

    def _run(section: Dict, name: str, label: str, fn) -> None:
        nonlocal n_viols
        tc = time.perf_counter()
        try:
            rep = fn()
        except Exception as e:   # an unanalysable cell is itself a finding
            rep = {"violations": [{
                "rule": "analyzer-error", "where": name,
                "detail": f"{type(e).__name__}: {e}"}]}
        timings[label] = round(time.perf_counter() - tc, 3)
        section[name] = rep
        n_viols += len(rep["violations"])
        if verbose:
            status = ("ok" if not rep["violations"]
                      else f"{len(rep['violations'])} VIOLATIONS")
            print(f"# {label}: {status} ({timings[label]}s)", flush=True)

    matrix: Dict[str, Dict] = {}
    for alg_name, codec in _cells(only):
        cell = f"{alg_name}x{codec}"
        _run(matrix, cell, cell,
             lambda a=alg_name, c=codec: analyze_cell(
                 a, c, device=device, donation=donation))
    exchange: Dict[str, Dict] = {}
    for codec, transport in _exchange_cells(only):
        cell = _exchange_cell_name(codec, transport)
        _run(exchange, cell, cell,
             lambda c=codec, t=transport: analyze_exchange_cell(
                 c, t, mesh=mesh))
    rs_section: Dict[str, Dict] = {}
    if only is None or only in "rs_transport":
        _run(rs_section, "rs_transport", "rs_transport", rs_transport_audit)
    sentinels: Dict[str, Dict] = {}
    if sentinel:
        for alg_name, codec in _cells(only):
            if codec == "lattice":   # one scanned run per algorithm
                _run(sentinels, alg_name, f"sentinel:{alg_name}",
                     lambda a=alg_name: sentinel_run(a, device=device))
    timings["total"] = round(time.perf_counter() - t0, 3)
    return {
        "schema": "analysis.port.v1",
        "quick": bool(quick),
        "device": device.type,
        "violations_total": n_viols,
        "ast": {"root": os.path.relpath(src_root, os.getcwd()),
                "violations": [v.as_dict() for v in ast_viols]},
        "matrix": matrix,
        "exchange": exchange,
        "rs_transport": rs_section.get("rs_transport", {}),
        "sentinel": sentinels,
    }


def _parse(argv):
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="skip the in-place audits and the sentinel runs")
    p.add_argument("--only", default=None,
                   help="run only the cells whose name contains this")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the report to PATH")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the checks run (default: the card)")
    p.add_argument("--list", action="store_true",
                   help="print every cell name, then exit")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.list:
        for name in list_cells():
            print(name)
        return 0
    timings: Dict[str, float] = {}
    report = run_lint(quick=args.quick, only=args.only, device=args.device,
                      timings=timings)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"# wrote {args.json}")
    n = report["violations_total"]
    print(f"# repro_torch.analysis.lint: {n} violation(s) in "
          f"{timings['total']}s on {report['device']}")
    for v in report["ast"]["violations"]:
        print(f"AST  {v['rule']} {v['where']}: {v['detail']}")
    for _, rep in (list(report["matrix"].items())
                   + list(report["exchange"].items())
                   + [("rs_transport", report["rs_transport"])]
                   + list(report["sentinel"].items())):
        for v in rep.get("violations", []):
            print(f"CELL {v['rule']} {v['where']}: {v['detail']}")
    return min(n, 125)


if __name__ == "__main__":
    sys.exit(main())
