"""Run an algorithm to a budget and trace it (port of
``repro.fed.simulate``); :func:`compare` does it for a named set of
algorithms under one simulated clock, at equal simulated time or equal
bits.

A trace row holds the round's metrics (the :data:`METRIC_KEYS` schema, per
round as the algorithm returned them) plus ``round``, ``wall_time_s``, the
cumulative ``bits_up_total`` / ``bits_down_total``, and whatever the
optional ``eval_fn`` returns (dicts merge in; a scalar lands under
``"eval"``).

**Two engines** produce that trace:

  * **eager** (the default): one Python iteration a round. Any algorithm
    runs here, host-control ones too (the host FedBuff's event heap).
    Device values reach the host only where a row is recorded or a budget
    is checked.
  * **scanned** (``scan_chunk=K``, K >= 2, or ``"auto"``): for algorithms
    with the ``device_round`` capability (:mod:`repro_torch.fed.engine`),
    up to K rounds a chunk through :meth:`RoundEngine.run_chunk`, with one
    host copy of the chunk's metrics. On the card a chunk is a captured
    CUDA graph, replayed; on the CPU a plain loop. The rounds draw from the
    run's generator in the eager order, so every row is the eager run's.
    As in the reference: ``until_sim_time`` and ``until_bits`` are checked
    at chunk boundaries only (the run may overshoot by up to one chunk),
    chunks shrink so that eval rounds land on chunk boundaries, and
    ``wall_time_s`` is the chunk's recording time for each of its rows.
    An algorithm without the capability silently runs the eager engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.fed.api import FedAlgorithm, normalize_metrics
from repro_torch.fed.engine import RoundEngine, clone_tree, supports_scan


@dataclass
class Trace:
    """The single trace format every simulation emits."""
    algorithm: str
    rows: List[Dict[str, Any]] = field(default_factory=list)
    final_state: Any = None
    rounds: int = 0
    wall_time_s: float = 0.0
    eval_time_s: float = 0.0   # host time spent inside eval_fn
    engine: str = "eager"      # 'eager' | 'scanned'
    scan_chunk: int = 0        # resolved chunk length (scanned engine only)

    @property
    def us_per_round(self) -> float:
        """Mean wall time per round, EXCLUDING eval_fn time, so a timing
        measures round cost, not eval cadence."""
        return ((self.wall_time_s - self.eval_time_s)
                / max(self.rounds, 1) * 1e6)

    @property
    def final(self) -> Dict[str, Any]:
        return self.rows[-1] if self.rows else {}

    def column(self, key: str) -> List[Any]:
        return [r.get(key) for r in self.rows]


class _Recorder:
    """Rows and evals, shared by both engines so that the scanned engine
    emits exactly the eager engine's rows."""

    def __init__(self, trace: Trace, alg, eval_fn, on_row, t0: float):
        self.trace, self.alg = trace, alg
        self.eval_fn, self.on_row, self.t0 = eval_fn, on_row, t0
        self.state = None          # kept current by the driving loop
        self.evaled_round = 0      # last round whose row carried an eval

    def run_eval(self, r: int):
        t_e = time.time()
        res = self.eval_fn(self.alg.eval_params(self.state))
        self.trace.eval_time_s += time.time() - t_e
        self.evaled_round = r
        return res if isinstance(res, dict) else {"eval": res}

    def record(self, r: int, metrics, bits_up, bits_down, do_eval: bool):
        row = dict(normalize_metrics(metrics), round=r,
                   bits_up_total=bits_up, bits_down_total=bits_down,
                   wall_time_s=time.time() - self.t0)
        if do_eval and self.eval_fn is not None:
            row.update(self.run_eval(r))
        self.trace.rows.append(row)
        if self.on_row is not None:
            self.on_row(row)

    def finalize(self, r: int, metrics, bits_up, bits_down):
        """Backstop exit: the final round gets an evaluated row; a row
        already recorded (and streamed) for it without an eval is updated
        in place, so ``on_row`` fires once a round."""
        rows = self.trace.rows
        if r and (not rows or rows[-1]["round"] != r):
            self.record(r, metrics, bits_up, bits_down, True)
        elif r and self.eval_fn is not None and self.evaled_round != r:
            rows[-1].update(self.run_eval(r))


def simulate(alg: FedAlgorithm, params0, data, generator: torch.Generator,
             *, rounds: Optional[int] = None,
             until_sim_time: Optional[float] = None,
             until_bits: Optional[float] = None,
             eval_every: int = 10, record_every: int = 0,
             eval_fn: Optional[Callable[[Any], Any]] = None,
             on_row: Optional[Callable[[Dict[str, Any]], None]] = None,
             name: str = "", max_rounds: int = 100_000,
             scan_chunk: Union[int, str] = 0) -> Trace:
    """Run ``alg`` from ``params0`` until the budget is exhausted. Budgets
    compose (first hit wins): ``rounds`` server rounds, ``until_sim_time``
    simulated seconds, ``until_bits`` total bits (up + down);
    ``max_rounds`` is the backstop, and the final round always gets an
    evaluated row. ``eval_fn(params)`` runs every ``eval_every`` rounds and
    on the final round; ``record_every`` adds metrics-only rows; ``on_row``
    streams each row as it is recorded, once per round. The trace is
    labelled ``name``, else the algorithm's class name.

    ``scan_chunk=K`` (K >= 2) runs the scanned engine for an algorithm
    with the ``device_round`` or ``scan_rounds`` capability (the module
    docstring has its semantics; others run eagerly). ``scan_chunk="auto"``
    first tunes K (:meth:`RoundEngine.autotune`) on a disposable state and
    a copy of ``generator``, so the run's draws, and its trace, are those
    of the chosen K given explicitly; ``Trace.scan_chunk`` holds it."""
    if rounds is None and until_sim_time is None and until_bits is None:
        raise ValueError("give at least one budget: rounds / until_sim_time "
                         "/ until_bits")
    if scan_chunk != "auto" and not (isinstance(scan_chunk, int)
                                     and scan_chunk >= 0):
        raise ValueError(f"scan_chunk must be an int >= 0 or 'auto'; got "
                         f"{scan_chunk!r}")
    if (scan_chunk == "auto" or scan_chunk > 1) and supports_scan(alg):
        return _simulate_scanned(
            alg, params0, data, generator, rounds=rounds,
            until_sim_time=until_sim_time, until_bits=until_bits,
            eval_every=eval_every, record_every=record_every,
            eval_fn=eval_fn, on_row=on_row, name=name,
            max_rounds=max_rounds, scan_chunk=scan_chunk)
    trace = Trace(algorithm=name or type(alg).__name__)
    state = alg.init(params0)
    # the run reads params0 no more: a caller that handed over its last
    # reference (an LM at full width) gets the memory back
    del params0
    bits_up = bits_down = 0.0
    t0 = time.time()
    rec = _Recorder(trace, alg, eval_fn, on_row, t0)
    limit = min(rounds, max_rounds) if rounds is not None else max_rounds
    r = 0
    metrics = {}
    done = False
    while r < limit and not done:
        state, metrics = alg.round(state, data, generator)
        rec.state = state
        r += 1
        bits_up += float(metrics.get("bits_up", 0.0))
        bits_down += float(metrics.get("bits_down", 0.0))
        done = rounds is not None and r >= rounds
        if not done and until_sim_time is not None:
            done = float(metrics.get("sim_time", 0.0)) >= until_sim_time
        if not done and until_bits is not None:
            done = bits_up + bits_down >= until_bits
        do_eval = done or (eval_every and r % eval_every == 0)
        if do_eval or (record_every and r % record_every == 0):
            rec.record(r, metrics, bits_up, bits_down, do_eval)
    rec.state = state
    rec.finalize(r, metrics, bits_up, bits_down)
    trace.final_state = state
    trace.rounds = r
    trace.wall_time_s = time.time() - t0
    return trace


def round_engine(alg) -> RoundEngine:
    """The algorithm's round engine, made on first use and kept on the
    algorithm, so repeated runs (compare sweeps, timing repeats) reuse its
    captured chunks."""
    engine = getattr(alg, "_round_engine", None)
    if engine is None or engine.alg is not alg:
        engine = RoundEngine(alg)
        alg._round_engine = engine
    return engine


def _host_rows(stacked, n: int) -> List[Dict[str, Any]]:
    """The chunk's per-round metrics as host numbers, from ONE host copy
    of every (length,) tensor metric (fp64 holds the fp32 values and the
    integer bits exactly); host constants repeat in every row."""
    keys = [k for k, v in stacked.items()
            if isinstance(v, torch.Tensor) and v.dim() == 1]
    consts = {k: v for k, v in stacked.items()
              if not isinstance(v, torch.Tensor)}
    host = (torch.stack([stacked[k].to(torch.float64) for k in keys])
            .cpu().tolist() if keys else [])
    return [{**consts, **{k: host[a][j] for a, k in enumerate(keys)}}
            for j in range(n)]


def _simulate_scanned(alg, params0, data, generator, *, rounds,
                      until_sim_time, until_bits, eval_every, record_every,
                      eval_fn, on_row, name, max_rounds, scan_chunk
                      ) -> Trace:
    """The scanned engine: chunks of up to ``scan_chunk`` rounds, one host
    copy of the metrics a chunk. The cumulative bits are added on the host
    in the eager loop's python float arithmetic, so the totals match."""
    trace = Trace(algorithm=name or type(alg).__name__, engine="scanned")
    engine = round_engine(alg)
    limit = min(rounds, max_rounds) if rounds is not None else max_rounds
    if scan_chunk == "auto":
        cap = limit
        if eval_fn is not None and eval_every:
            cap = min(cap, eval_every)
        probe = torch.Generator(device=generator.device)
        probe.set_state(generator.get_state())
        scan_chunk = engine.autotune(params0, data, probe, cap=cap)
    trace.scan_chunk = int(scan_chunk)
    state = alg.init(params0)
    del params0
    bits_up = bits_down = 0.0
    t0 = time.time()
    rec = _Recorder(trace, alg, eval_fn, on_row, t0)
    r = 0
    metrics = {}
    done = False
    while r < limit and not done:
        n = limit - r
        if eval_fn is not None and eval_every:
            # shrink so eval rounds land on chunk boundaries, where the
            # state (hence eval_params) is there to read
            n = min(n, eval_every - (r % eval_every))
        n = min(n, scan_chunk)
        state, stacked = engine.run_chunk(state, data, generator, n)
        rec.state = state
        for j, mj in enumerate(_host_rows(stacked, n)):
            rj = r + j + 1
            bits_up += float(mj.get("bits_up", 0.0))
            bits_down += float(mj.get("bits_down", 0.0))
            done_j = rounds is not None and rj >= rounds
            at_boundary = j == n - 1
            # sim-time / bits budgets: checked at chunk boundaries only
            if not done_j and at_boundary and until_sim_time is not None:
                done_j = float(mj.get("sim_time", 0.0)) >= until_sim_time
            if not done_j and at_boundary and until_bits is not None:
                done_j = bits_up + bits_down >= until_bits
            do_eval = done_j or (eval_every and rj % eval_every == 0)
            if do_eval or (record_every and rj % record_every == 0):
                # an eval only ever fires at a boundary (chunks are aligned)
                rec.record(rj, mj, bits_up, bits_down,
                           do_eval and at_boundary)
            done = done or done_j
            metrics = mj
        r += n
    rec.state = state
    rec.finalize(r, metrics, bits_up, bits_down)
    # on the card the state is the engine's static buffers, which its next
    # chunk overwrites: the trace keeps a copy
    trace.final_state = (clone_tree(state)
                         if generator.device.type == "cuda" else state)
    trace.rounds = r
    trace.wall_time_s = time.time() - t0
    return trace


def compare(algorithms: Dict[str, Any], params0, data,
            generator: torch.Generator, **sim_kw) -> Dict[str, Trace]:
    """Run every named algorithm from the SAME initial params, the same
    generator state and the same budget (``simulate``'s keywords); returns
    ``{name: Trace}`` in input order. Each run gets its own copy of
    ``generator``, so every algorithm starts from the same draws."""
    state = generator.get_state()
    traces = {}
    for name, alg in algorithms.items():
        gen = torch.Generator(device=generator.device)
        gen.set_state(state)
        traces[name] = simulate(alg, params0, data, gen, name=name, **sim_kw)
    return traces
