"""Run an algorithm to a budget and trace it (port of the eager path of
``repro.fed.simulate``); :func:`compare` does it for a named set of
algorithms under one simulated clock.

A trace row holds the round's metrics (the :data:`METRIC_KEYS` schema, per
round as the algorithm returned them) plus ``round``, ``wall_time_s``, the
cumulative ``bits_up_total`` / ``bits_down_total``, and whatever the
optional ``eval_fn`` returns (dicts merge in; a scalar lands under
``"eval"``). Device values reach the host only where a row is recorded.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.fed.api import normalize_metrics


@dataclass
class Trace:
    """The single trace format every simulation emits."""
    algorithm: str
    rows: List[Dict[str, Any]] = field(default_factory=list)
    final_state: Any = None
    rounds: int = 0
    wall_time_s: float = 0.0

    @property
    def final(self) -> Dict[str, Any]:
        return self.rows[-1] if self.rows else {}

    def column(self, key: str) -> List[Any]:
        return [r.get(key) for r in self.rows]


def simulate(alg, params0, data, generator: torch.Generator, *,
             rounds: Optional[int] = None,
             until_sim_time: Optional[float] = None,
             eval_every: int = 10, record_every: int = 0,
             eval_fn: Optional[Callable[[Any], Any]] = None,
             on_row: Optional[Callable[[Dict[str, Any]], None]] = None,
             name: str = "", max_rounds: int = 100_000) -> Trace:
    """Run ``alg`` from ``params0`` until ``rounds`` server rounds or
    ``until_sim_time`` simulated seconds (first hit wins; ``max_rounds`` is
    the backstop). ``eval_fn(params)`` runs every ``eval_every`` rounds and
    on the final round; ``record_every`` adds metrics-only rows;
    ``on_row`` streams each row as it is recorded. The trace is labelled
    ``name``, else the algorithm's class name."""
    if rounds is None and until_sim_time is None:
        raise ValueError("give at least one budget: rounds / "
                         "until_sim_time")
    trace = Trace(algorithm=name or type(alg).__name__)
    state = alg.init(params0)
    bits_up = bits_down = 0.0
    t0 = time.time()
    limit = min(rounds, max_rounds) if rounds is not None else max_rounds

    def record(r, metrics, do_eval):
        row = dict(normalize_metrics(metrics), round=r,
                   bits_up_total=bits_up, bits_down_total=bits_down,
                   wall_time_s=time.time() - t0)
        if do_eval and eval_fn is not None:
            res = eval_fn(alg.eval_params(state))
            row.update(res if isinstance(res, dict) else {"eval": res})
        trace.rows.append(row)
        if on_row is not None:
            on_row(row)

    r = 0
    done = False
    while r < limit and not done:
        state, metrics = alg.round(state, data, generator)
        r += 1
        bits_up += float(metrics.get("bits_up", 0.0))
        bits_down += float(metrics.get("bits_down", 0.0))
        done = rounds is not None and r >= rounds
        if not done and until_sim_time is not None:
            done = float(metrics.get("sim_time", 0.0)) >= until_sim_time
        do_eval = done or (eval_every and r % eval_every == 0)
        if do_eval or (record_every and r % record_every == 0):
            record(r, metrics, do_eval)
    if r and (not trace.rows or trace.rows[-1]["round"] != r):
        record(r, metrics, True)      # backstop exit: the final row
    trace.final_state = state
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
