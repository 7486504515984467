"""Runtime invariants of the port (port of ``repro.analysis``).

The reference walks jaxprs; the port checks what its rounds do:

* the op log of a round (:mod:`.jaxpr`: ``RoundTrace`` over
  ``RoundEngine.traced_round`` / ``traced_chunk``): host syncs, 64-bit
  values, draws from the default generator, the op report;
* :mod:`.opbudget` (rotation counters, collective bytes), :mod:`.wire`
  (the marked messages of :mod:`.provenance` against the codecs' declared
  wire), :mod:`.intervals` (the γ wrap window, on ``make_fx`` graphs),
  :mod:`.divergence` (replicated outputs equal across ranks),
  :mod:`.sentinel` (one chunk program a length), :mod:`.donation` (the
  in-place audit);
* :mod:`.astlint`, source rules over ``src/repro_torch/``;
* :mod:`.lint`, the gate over the whole matrix
  (``python -m repro_torch.analysis.lint``).

The names below are the reference's exports less its dataflow engine's
(``analyze_flow``, ``FlowContext`` and the ``*Domain`` classes, ``iter_eqns``:
there is no jaxpr to walk), plus the op log's. They load on first use:
``compression``, ``kernels`` and ``launch/mesh.py`` import
:mod:`.provenance` at load, so this package pulls in nothing else when it
is imported.
"""
from importlib import import_module

_EXPORTS = {
    "check_divergence": "divergence",
    "check_encode_intervals": "intervals", "check_gamma_window": "intervals",
    "check_rs_gamma_window": "intervals", "interval_of": "intervals",
    "RoundTrace": "jaxpr", "analyze_jaxpr": "jaxpr",
    "analyze_round": "jaxpr", "check_host_callbacks": "jaxpr",
    "check_host_syncs": "jaxpr", "check_key_discipline": "jaxpr",
    "check_wide_dtypes": "jaxpr", "op_counts": "jaxpr", "op_report": "jaxpr",
    "OpBudget": "opbudget", "check_rotation_budget": "opbudget",
    "rotation_budget": "opbudget",
    "WireRecorder": "provenance", "wire_mark": "provenance",
    "RecompileSentinel": "sentinel",
    "check_wire_truth": "wire", "collect_wire_facts": "wire",
    "Violation": "violation",
    "donation_report": "donation",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
