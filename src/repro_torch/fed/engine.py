"""The round engine: K rounds at a time, one host sync per chunk (port of
``repro.fed.engine``).

* **The ``device_round`` capability.** An algorithm whose
  ``device_round(state, data, generator) -> (state, metrics)`` reads and
  writes every value that changes from round to round as a tensor (no
  ``float()``, ``int()``, ``.item()`` or other host read inside, the metrics
  dict the same keys every round) can run K rounds as one chunk.
  :class:`DeviceFedAlgorithm` is the structural type and
  :func:`supports_scan` the capability check. An algorithm whose control
  needs the host between rounds (the adaptive bit-width walk) provides
  ``scan_rounds(state, data, generator, length)`` and chunks itself; one
  with host set-up before its first round (the device FedBuff seeds its
  ring) provides ``begin(state, generator) -> state``, which the engine
  calls before each chunk, outside any captured region. One that draws
  from generators of its own besides the caller's (the mesh algorithm's
  exchange streams) lists them in ``generators()``: the engine registers
  them with its graphs and keeps the warm-up from moving them.

* **:class:`RoundEngine`.** ``run_chunk`` runs ``length`` rounds. On the
  CPU it is a plain Python loop over ``device_round``, the engine's plain
  version. On the card the rounds are captured once into a
  ``torch.cuda.CUDAGraph`` per (length, data tensors) and replayed after
  that, so a chunk costs one graph launch instead of a few hundred kernel
  launches a round. A chunk that cannot be captured raises; the engine
  never runs a CUDA chunk eagerly unless built with ``capture=False``.
  The mesh algorithm (``spmd``) captures its collectives too: its state
  stays on the rank's device, and a chunk replays the process group's
  collectives inside the graph. So does an algorithm whose population
  store is split across ranks (``client_mesh``): its all-gathers of the
  cohort's rows replay inside the graph, and the store stays split
  between chunks. Capture runs in thread-local mode, so a process group's
  watchdog thread may poll its events meanwhile.

* **The analyzer hooks** (``repro_torch.analysis``). ``traced_round`` /
  ``traced_chunk`` give the op log of one round or a chunk
  (``analysis/jaxpr.RoundTrace``), ``wire_provenance`` its wire marks and
  collectives, ``lowered_chunk`` the kernel nodes of a chunk captured on
  the card. They run on a copy of the state with every generator put
  back: every round draws, and a generator makes no ``meta`` tensors, so
  no round can run abstractly. ``chunk_programs`` and ``copies`` are what
  the recapture sentinel and the in-place audit read after a run;
  :func:`sync_debug` runs every captured round under
  ``torch.cuda.set_sync_debug_mode``.

* **:class:`RingBuffer`.** A fixed-capacity event set on the device (times
  and client ids, empty slots at ``+inf``) in place of the host heap
  :class:`repro_torch.fed.clock.ArrivalQueue`. ``ring_pop`` is a masked min
  with the heap's lexicographic ``(time, client)`` tie-break and no host
  sync.

* **The seed bridge.** :func:`fedbuff_completion_table` replays the port
  ``FedBuff``'s numpy event stream into a ``(client, occurrence) ->
  duration`` table, so the device FedBuff consumes the same durations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import re
import sys
import time
from collections import Counter
from typing import (Any, Dict, List, NamedTuple, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.fed.api import FedAlgorithm
from repro_torch.fed.clock import ArrivalQueue, completion_time
from repro_torch.utils import spans


@runtime_checkable
class DeviceFedAlgorithm(FedAlgorithm, Protocol):
    """A :class:`FedAlgorithm` whose round can be run in chunks: every
    value it reads or writes that changes between rounds is a tensor, and
    its metrics dict has the same keys every round. ``round`` may simply
    alias ``device_round``."""

    def device_round(self, state, data, generator
                     ) -> Tuple[Any, Dict[str, Any]]:
        ...


def supports_scan(alg) -> bool:
    """True if ``alg`` can run chunks: through the generic
    ``device_round`` capability or its own ``scan_rounds``."""
    return (callable(getattr(alg, "device_round", None))
            or callable(getattr(alg, "scan_rounds", None)))


# ---------------------------------------------------------------------------
# the device event queue (in place of clock.ArrivalQueue's heap)
# ---------------------------------------------------------------------------

class RingBuffer(NamedTuple):
    """Fixed-capacity (time, client) event set. Empty slots hold ``times =
    +inf`` and ``clients = -1``, so the masked-min pop skips them."""
    times: torch.Tensor     # (cap,) fp32
    clients: torch.Tensor   # (cap,) int64

    @property
    def capacity(self) -> int:
        return self.times.shape[0]


_BIG = torch.iinfo(torch.int64).max


def ring_init(capacity: int, device=None) -> RingBuffer:
    return RingBuffer(
        times=torch.full((capacity,), float("inf"), device=device),
        clients=torch.full((capacity,), -1, dtype=torch.int64,
                           device=device))


def ring_size(rb: RingBuffer) -> torch.Tensor:
    """The number of pending events, a 0-d int64 tensor."""
    return torch.isfinite(rb.times).sum()


def _set(x: torch.Tensor, slot: torch.Tensor, val) -> torch.Tensor:
    """``x`` with ``x[slot] = val``: a tensor value by ``index_put``, a
    host scalar by ``index_fill`` (a kernel argument, no host copy)."""
    slot = slot.reshape(1)
    if isinstance(val, torch.Tensor):
        return x.index_put((slot,), val.to(x.dtype).reshape(1))
    return x.index_fill(0, slot, val)


def ring_push(rb: RingBuffer, t, client) -> RingBuffer:
    """Insert into the first empty slot. The caller must not push into a
    full buffer (FedBuff holds one pending event per client, so capacity =
    n_clients is never exceeded)."""
    slot = torch.argmax((~torch.isfinite(rb.times)).to(torch.int32))
    return RingBuffer(times=_set(rb.times, slot, t),
                      clients=_set(rb.clients, slot, client))


def _at_min(rb: RingBuffer, t_min: torch.Tensor) -> torch.Tensor:
    """The slots whose time is the minimum. A NaN time (an exhausted
    seed-bridge table) is the minimum ``torch.min`` returns, and it pops
    first, so the NaN reaches the clock with a valid client id."""
    return (rb.times == t_min) | torch.isnan(rb.times)


def ring_peek(rb: RingBuffer) -> Tuple[torch.Tensor, torch.Tensor]:
    """(time, client) of the next event, the heap's lexicographic min:
    smallest time, ties to the smallest client id (then the first slot)."""
    t_min = torch.min(rb.times)
    cand = torch.where(_at_min(rb, t_min), rb.clients,
                       torch.full_like(rb.clients, _BIG))
    return t_min, torch.min(cand)


def ring_pop(rb: RingBuffer
             ) -> Tuple[RingBuffer, torch.Tensor, torch.Tensor]:
    """Remove and return the lexicographic-min event: the masked-min form
    of ``heapq.heappop`` on ``(time, client)`` tuples."""
    t_min, c_min = ring_peek(rb)
    slot = torch.argmax((_at_min(rb, t_min) & (rb.clients == c_min))
                        .to(torch.int32))
    out = RingBuffer(times=_set(rb.times, slot, float("inf")),
                     clients=_set(rb.clients, slot, -1))
    return out, t_min, c_min


# ---------------------------------------------------------------------------
# the seed bridge: the port FedBuff's numpy event stream as a device table
# ---------------------------------------------------------------------------

def fedbuff_event_seed(generator: torch.Generator) -> int:
    """The integer ``FedBuff``'s first round will draw from ``generator``
    to seed its event rng, read from a copy, so ``generator`` does not
    move."""
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return int(torch.randint(0, 2**31 - 1, (1,), generator=g,
                             device=g.device))


def fedbuff_completion_table(seed: int, lam, local_steps: int,
                             n_events: int) -> np.ndarray:
    """Replay the port ``FedBuff``'s event stream on the host and return
    ``table[i, k]``, the duration drawn for client ``i``'s ``k``-th
    completion (fp32, ``(n, n_events + 1)``).

    The numpy rng is seeded from ``seed``, the integer ``FedBuff._seed``
    draws (:func:`fedbuff_event_seed`; a test may pass the one the
    reference derives from its key), and consumed in ``FedBuff``'s order:
    n initial draws (clients 0..n-1), then one redraw a pop, in pop order.
    So a device FedBuff reading ``table[i, occ_i]`` sees the durations the
    host FedBuff draws."""
    rng = np.random.default_rng(int(seed))
    n = len(lam)
    table = np.zeros((n, n_events + 1), np.float32)
    occ = np.zeros(n, np.int64)
    q = ArrivalQueue()
    for i in range(n):
        d = completion_time(rng, local_steps, lam[i])
        table[i, 0] = d
        occ[i] = 1
        q.push(d, i)
    for _ in range(n_events):
        t_now, i = q.pop()
        d = completion_time(rng, local_steps, lam[i])
        if occ[i] >= table.shape[1]:   # one client absorbed every event
            table = np.pad(table, ((0, 0), (0, n_events)))
        table[i, occ[i]] = d
        occ[i] += 1
        q.push(t_now + d, i)
    return table


# ---------------------------------------------------------------------------
# state trees: NamedTuples, dataclasses, tuples, lists and dicts around
# tensor leaves
# ---------------------------------------------------------------------------

def _is_dataclass(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if _is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, it) for v in tree]
        if hasattr(tree, "_fields"):            # a NamedTuple
            return type(tree)(*vals)
        return type(tree)(vals)
    if _is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    return next(it)


def clone_tree(tree):
    """A copy of a state whose tensors are fresh (host leaves shared): a
    round consumes its state, so copy one to run it twice."""
    return _rebuild(tree, iter([x.clone() if isinstance(x, torch.Tensor)
                                else x for x in _leaves(tree)]))


def _host_leaves(tree) -> List[Any]:
    return [x for x in _leaves(tree) if not isinstance(x, torch.Tensor)]


def _check_host_leaves(before, after, alg) -> None:
    """A chunk must leave every host (non-tensor) leaf of the state as it
    was: a host value that a round changes would be frozen by capture."""
    if _host_leaves(before) != _host_leaves(after):
        raise ValueError(
            f"{type(alg).__name__}.device_round changed a host value of its "
            f"state ({_host_leaves(before)} -> {_host_leaves(after)}); every "
            f"value that changes between rounds must be a tensor")


def stack_metrics(ms: List[Dict[str, Any]], alg=None) -> Dict[str, Any]:
    """A chunk's per-round metrics: each tensor metric stacked to
    ``(length, ...)``; a host constant kept as it is. A host value that
    differs between rounds raises: a captured chunk would freeze it."""
    out = {}
    for k in ms[0]:
        vals = [m[k] for m in ms]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack(vals)
        elif all(v == vals[0] for v in vals):
            out[k] = vals[0]
        else:
            raise ValueError(
                f"metric {k!r} of {type(alg).__name__} is a host value that "
                f"changes from round to round ({vals}); it must be a tensor")
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# chunk lengths the autotuner probes (each costs one capture and two runs)
AUTOTUNE_CANDIDATES = (4, 16, 64)


class _Graph(NamedTuple):
    """One captured chunk: the graph, the static state it reads and writes
    in place, its stacked metrics (static outputs), the tensors of the
    data it reads (kept alive), its timings, and, when it was captured
    with spans on, the log of its spans (``utils/spans.captured``)."""
    graph: Any
    state: Any
    metrics: Dict[str, Any]
    data: List[torch.Tensor]
    times: Dict[str, float]
    spans: Any = None


def _data_key(data) -> Tuple:
    return tuple((x.data_ptr(), tuple(x.shape), x.dtype)
                 for x in _leaves(data) if isinstance(x, torch.Tensor))


class RoundEngine:
    """Runs an algorithm's rounds in chunks of ``length`` rounds.

    On the CPU a chunk is a Python loop over ``device_round``. On the card
    the first chunk of each (length, data tensors) is captured into a CUDA
    graph, after a warm-up round on a copy of the state (it builds the
    kernels and the per-device constants without moving any generator);
    later chunks replay it. Every capture draws from one generator the
    engine owns, registered with each graph; a replay starts from the
    caller's generator state and hands the advanced state back, so a chunk
    consumes the caller's generator exactly as the same rounds run eagerly
    would. All graphs share one memory pool. A chunk run with spans on
    (``utils/spans.recording``) is a graph of its own, with the spans'
    timing events as nodes: the spans flag is part of a chunk's key.

    The state a chunk returns is the graph's static buffers, updated in
    place by the next replay; the state passed in is consumed (copied into
    those buffers unless it is them). The stacked metrics are copies.
    ``capture=False`` runs CUDA chunks as the plain loop, only when a
    caller asks for it.
    """

    def __init__(self, alg, capture: bool = True):
        if not supports_scan(alg):
            raise TypeError(
                f"{type(alg).__name__} exposes neither device_round nor "
                "scan_rounds; run it through the eager simulate() path")
        self.alg = alg
        self.capture = capture
        self.tuned_chunk = None
        self._graphs: Dict[Tuple, _Graph] = {}
        # the plain loop's chunk programs, as the graphs' keys: (length,
        # data) -> (the data's tensors, kept alive as a graph keeps them;
        # the state the last chunk returned)
        self._loops: Dict[Tuple, Tuple[List[torch.Tensor], Any]] = {}
        # (leaves, bytes) copied into each chunk that ran a program made
        # before it: 0 when it is fed the state the previous one returned
        self.copies: List[Tuple[int, int]] = []
        self._gen = None      # the generator every capture draws from
        self._pool = None
        self._stream = None

    # -- autotune -------------------------------------------------------------
    def autotune(self, params0, data, generator, cap: int = 0,
                 candidates=AUTOTUNE_CANDIDATES) -> int:
        """Pick a chunk length from measured ms per round: each candidate
        (bounded by ``cap`` when given) runs two chunks on a disposable
        ``alg.init(params0)`` state, the first paying capture and warm-up,
        the second timed. ``generator`` should be a copy of the run's, so
        tuning does not move the run's draws. The winner is kept, and its
        captured graph serves the run."""
        if self.tuned_chunk is not None:
            return self.tuned_chunk
        cands = sorted({min(c, cap) if cap else c
                        for c in candidates if c >= 2}) or [2]
        cuda = generator.device.type == "cuda"
        best, best_ms = cands[0], float("inf")
        state = self.alg.init(params0)
        for c in cands:
            state, _ = self.run_chunk(state, data, generator, c)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = self.run_chunk(state, data, generator, c)
            if cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / c * 1e3
            if ms < best_ms:
                best, best_ms = c, ms
        self.tuned_chunk = best
        return best

    # -- chunks ---------------------------------------------------------------
    def run_chunk(self, state, data, generator: torch.Generator,
                  length: int):
        """Advance ``length`` rounds; returns ``(state, stacked)``, where
        ``stacked`` maps each tensor metric to its ``(length, ...)`` rounds
        and keeps host constants as they are. ``generator`` advances as
        the same rounds run eagerly would advance it."""
        custom = getattr(self.alg, "scan_rounds", None)
        if custom is not None:
            return custom(state, data, generator, length)
        begin = getattr(self.alg, "begin", None)
        if begin is not None:
            state = begin(state, generator)
        key = (length, _data_key(data), spans.on())
        if generator.device.type != "cuda" or not self.capture:
            return self._loop(state, data, generator, length, key)
        return self._replay(state, data, generator, key)

    def _loop(self, state, data, generator, length, key):
        """The plain version: ``length`` calls of ``device_round``. The
        chunk's program and the state it returns are kept by ``key``, as
        a capture keeps them, for :meth:`chunk_programs` and
        :attr:`copies`."""
        prev = self._loops.get(key)
        if prev is not None:
            self.copies.append(_fresh_leaves(prev[1], state))
        st, ms = state, []
        for _ in range(length):
            st, m = self.alg.device_round(st, data, generator)
            ms.append(m)
        _check_host_leaves(state, st, self.alg)
        self._loops[key] = (_tensor_leaves(data), st)
        return st, stack_metrics(ms, self.alg)

    def chunk_programs(self) -> Dict[int, int]:
        """The chunk programs made so far, by length: captured graphs on
        the card, distinct (length, data) keys of the plain loop on the
        CPU. A run that keeps its data makes one a length; a chunk's twin
        captured with spans on is the same program."""
        return dict(Counter(key[0] for key in
                            {k[:2] for k in list(self._graphs)
                             + list(self._loops)}))

    def static_storages(self) -> set:
        """The storages of every captured graph's static state (empty on
        the CPU, where nothing is captured)."""
        return {x.untyped_storage().data_ptr() for g in self._graphs.values()
                for x in _tensor_leaves(g.state)}

    def graph_times(self) -> Dict[int, Dict[str, float]]:
        """Host ms of the warm-up, the capture and the instantiation of
        each captured chunk, by length (the chunk captured without spans
        where there are both)."""
        out = {}
        for key, g in self._graphs.items():
            if key[0] not in out or not key[2]:
                out[key[0]] = g.times
        return out

    def _replay(self, state, data, generator, key):
        g = self._graphs.get(key)
        fresh = g is None
        if fresh:
            g = self._graphs[key] = self._capture(state, data, key[0])
        with spans.span("engine.replay") as rec:
            if not fresh:
                self.copies.append(_load(g.state, state))
            self._gen.set_state(generator.get_state())
            g.graph.replay()
            generator.set_state(self._gen.get_state())
            metrics = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in g.metrics.items()}
        spans.replayed(g.spans, rec)
        return g.state, metrics

    def _capture(self, state, data, length, debug: bool = False) -> _Graph:
        dev = _leaves_device(state)
        if self._gen is None:
            self._gen = torch.Generator(device=dev)
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device=dev)
        gen = self._gen
        gens = self.generators_of(gen)
        times = {}
        static = clone_tree(state)
        # warm-up on a copy, on the capture stream, from saved generator
        # states that are then restored: kernels build, per-device
        # constants are made and nothing the run draws is consumed
        t0 = time.perf_counter()
        with kept(gens), spans.muted():
            warm = clone_tree(state)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                warm, _ = self.alg.device_round(warm, data, gen)
            torch.cuda.current_stream(dev).wait_stream(self._stream)
            torch.cuda.synchronize(dev)
            del warm
        times["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        # a debug capture keeps its cudaGraph_t past instantiation, so
        # that debug_dump can print it
        graph = torch.cuda.CUDAGraph(keep_graph=debug)
        if debug:
            graph.enable_debug_mode()
        for g in gens:
            graph.register_generator_state(g)
        # a dead graph whose cycle the collector frees inside the capture
        # (an earlier engine's, a failed capture's) is destroyed there and
        # invalidates it: no cycle is collected until the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            ctx = torch.cuda.graph(graph, pool=self._pool,
                                   stream=self._stream,
                                   capture_error_mode="thread_local")
            ctx.__enter__()
            try:
                with _sync_debug(), spans.captured() as tpl:
                    st, ms = static, []
                    for _ in range(length):
                        st, m = self.alg.device_round(st, data, gen)
                        ms.append(m)
                metrics = stack_metrics(ms, self.alg)
                _commit(static, st, self.alg)
            except BaseException:
                try:
                    ctx.__exit__(*sys.exc_info())
                except Exception:   # the capture's own error: keep the first
                    pass
                raise
            t1 = time.perf_counter()
            ctx.__exit__(None, None, None)
        finally:
            if collecting:
                gc.enable()
        times["capture_ms"] = (t1 - t0) * 1e3
        times["instantiate_ms"] = (time.perf_counter() - t1) * 1e3
        for phase in ("warmup", "capture", "instantiate"):
            spans.note(f"engine.{phase}", times[f"{phase}_ms"])
        return _Graph(graph, static, metrics, _tensor_leaves(data), times,
                      tpl)

    # -- analyzer hooks (repro_torch.analysis) --------------------------------
    def generators_of(self, generator) -> Tuple[torch.Generator, ...]:
        """The caller's generator and the algorithm's own."""
        return (generator,) + tuple(getattr(self.alg, "generators",
                                            tuple)())

    def _begun_copy(self, state, generator):
        """A copy of ``state`` as a chunk starts from it (``begin``
        applied)."""
        st = clone_tree(state)
        begin = getattr(self.alg, "begin", None)
        return st if begin is None else begin(st, generator)

    def traced_chunk(self, state, data, generator, length: int):
        """The op log (``analysis/jaxpr.RoundTrace``) of ``length`` rounds
        as a chunk runs them, ``begin`` outside it as in
        :meth:`run_chunk`. It runs on a copy of the state, every generator
        put back after it: nothing is consumed and no cached chunk is
        touched."""
        from repro_torch.analysis.jaxpr import RoundTrace
        with kept(self.generators_of(generator)):
            st = self._begun_copy(state, generator)
            with RoundTrace() as trace:
                for _ in range(length):
                    st, _ = self.alg.device_round(st, data, generator)
        return trace

    def traced_round(self, state, data, generator):
        """The op log of ONE round, ``device_round`` as a chunk calls it
        (see :meth:`traced_chunk`)."""
        return self.traced_chunk(state, data, generator, 1)

    def wire_provenance(self, state, data, generator):
        """``(trace, marks, collectives)`` of one round for the wire-truth
        audit: its op log, the wire marks it made
        (``analysis/provenance.WireMark``) and the mesh's collectives with
        whether each operand derives from a marked value."""
        trace = self.traced_round(state, data, generator)
        return trace, trace.marks, trace.collectives

    def lowered_chunk(self, state, data, generator, length: int
                      ) -> List[str]:
        """The kernel nodes of a ``length``-round chunk captured as a CUDA
        graph (``CUDAGraph.enable_debug_mode`` + ``debug_dump``), one label
        a node, in the dump's order. The capture is a graph of its own,
        from a copy of the state, on a fresh engine: neither the caller's
        generator nor this engine's cache moves. On the CPU a chunk is the
        plain loop and nothing is captured, so there is nothing to read:
        it raises."""
        if generator.device.type != "cuda":
            raise RuntimeError(
                "lowered_chunk reads the kernels of a captured CUDA graph; "
                "on the CPU a chunk runs as the plain loop of device_round "
                "and no graph is captured (use traced_chunk's op log)")
        import os
        import tempfile
        with kept(self.generators_of(generator)):
            st = self._begun_copy(state, generator)
        g = RoundEngine(self.alg)._capture(st, data, length, debug=True)
        fd, path = tempfile.mkstemp(suffix=".dot")
        os.close(fd)
        try:
            g.graph.debug_dump(path)
            with open(path) as f:
                return kernel_nodes(f.read())
        finally:
            os.remove(path)


@contextlib.contextmanager
def kept(generators):
    """Every generator in ``generators`` back at its state after the
    block."""
    saved = [g.get_state() for g in generators]
    try:
        yield
    finally:
        for g, st in zip(generators, saved):
            g.set_state(st)


def _leaves_device(state) -> torch.device:
    for x in _leaves(state):
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("the state holds no tensor")


def _tensor_leaves(tree) -> List[torch.Tensor]:
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _fresh_leaves(prev, state) -> Tuple[int, int]:
    """(leaves, bytes) of ``state`` that are not ``prev``'s own tensors:
    what a capture would copy into its static buffers."""
    pairs = [(p, x) for p, x in zip(_leaves(prev), _leaves(state))
             if isinstance(x, torch.Tensor) and p is not x]
    return len(pairs), sum(x.numel() * x.element_size() for _, x in pairs)


def _load(static, state) -> Tuple[int, int]:
    """Copy ``state`` into the static buffers, unless it is them; returns
    the (leaves, bytes) copied."""
    s_leaves, x_leaves = _leaves(static), _leaves(state)
    if (len(s_leaves) != len(x_leaves)
            or _host_leaves(static) != _host_leaves(state)):
        raise ValueError("the state does not match the captured chunk's")
    copied = _fresh_leaves(static, state)
    for s, x in zip(s_leaves, x_leaves):
        if isinstance(s, torch.Tensor) and s is not x:
            s.copy_(x)
    return copied


# torch.cuda.set_sync_debug_mode's mode around every round the engine
# captures (0: off); :func:`sync_debug` sets it
_SYNC_DEBUG = [0]


@contextlib.contextmanager
def sync_debug(mode="error"):
    """Inside the block, every ``device_round`` the engine captures runs
    under ``torch.cuda.set_sync_debug_mode(mode)``: an op that makes the
    host wait for the card warns ("warn") or raises ("error")."""
    prev, _SYNC_DEBUG[0] = _SYNC_DEBUG[0], mode
    try:
        yield
    finally:
        _SYNC_DEBUG[0] = prev


@contextlib.contextmanager
def _sync_debug():
    if not _SYNC_DEBUG[0]:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(_SYNC_DEBUG[0])
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def kernel_nodes(dot: str) -> List[str]:
    """The labels of the kernel nodes of a CUDA graph's debug dump (the
    DOT text ``cudaGraphDebugDotPrint`` writes), whitespace collapsed."""
    starts = [m.start() for m in re.finditer(r'^\s*"\w+"\s*\[', dot,
                                             re.M)]
    out = []
    for a, b in zip(starts, starts[1:] + [len(dot)]):
        block = dot[a:b]
        if "KERNEL" in block:
            out.append(" ".join(block.split()))
    return out


def _commit(static, out, alg) -> None:
    """Inside the capture: write the chunk's final state into the static
    buffers it started from. An output that is itself a static buffer at
    another place (a round that carries its input server on as the
    previous server) is copied first, so no write overwrites a value that
    a later write still reads."""
    _check_host_leaves(static, out, alg)
    s_leaves = [x for x in _leaves(static) if isinstance(x, torch.Tensor)]
    o_leaves = [x for x in _leaves(out) if isinstance(x, torch.Tensor)]
    ptrs = {x.untyped_storage().data_ptr() for x in s_leaves}
    pending = []
    for s, o in zip(s_leaves, o_leaves):
        if o is s:
            continue
        if o.dtype != s.dtype or o.shape != s.shape:
            raise ValueError(
                f"{type(alg).__name__}.device_round changed a state tensor "
                f"from {s.dtype}{tuple(s.shape)} to {o.dtype}"
                f"{tuple(o.shape)}")
        if o.untyped_storage().data_ptr() in ptrs:
            o = o.clone()
        pending.append((s, o))
    for s, o in pending:
        s.copy_(o)
