"""Spans and counters at the phase boundaries of a round, timed on the
device clock.

The span sites (``PERF.md`` §3 lists them with the metrics they feed):
``quafl.round`` and its five children ``quafl.cohort``, ``quafl.local``
(``local.step``, and under the per-client protocol ``local.grad`` and
``local.update``), ``quafl.progress``, ``quafl.exchange`` (``exchange.draws``,
``.uplink``, ``.downlink``, ``.average``, ``.unrotate``) and ``quafl.commit``;
the round engine's ``engine.replay``; and set-up: ``quafl.init``, and the
host-only notes ``build.load``, ``engine.warmup``, ``engine.capture`` and
``engine.instantiate``. The counters: ``local.steps_computed``,
``local.steps_active`` and ``exchange.fused_average`` (launches of the
fused uplink kernel, which sums the server average inside the snap;
counted by its wrapper where it launches, so the plain version counts
none).

**Off** (the default) :func:`span` is one module-level flag test that
returns a shared null context, and :func:`count` and :func:`note` return at
once: no torch call, no event, no allocation, so a round launches and
allocates exactly what it would without them.

**On** (inside :func:`recording`, which yields the :class:`SpanLog` the
spans fill):

* every span enters ``torch.profiler.record_function(name)``, so under a
  profiler it lies on the clock of CUPTI's device operations; outside a
  CUDA graph capture its ``time.perf_counter`` interval is kept too
  (inside one a host time says nothing about a replay);
* on the card, a pair of timing events is recorded on the current stream
  at enter and exit. Inside a capture they become event nodes of the graph
  and are timed again on every replay: the round engine captures a chunk's
  spans into a log of their own (:func:`captured`) and hands it to
  :func:`replayed` after each replay, which waits for the chunk's last
  event and keeps the times before the next replay records over them.
  A captured chunk holds ``quafl.round`` and its five phases only: the
  nested spans are ``eager_only``, since an event node costs the replay
  about as much as a small kernel;
* :func:`count` keeps what it is given, a device tensor as it is, and sums
  only when the log is read.

Nothing here syncs or reads a device value inside a round, and nothing
changes a value the round computes. A span's device interval runs from
its first event to its last as the stream reaches them, so on a
host-paced path it holds the device's idle time inside the span too.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

ROUND = "quafl.round"     # a span of this name opens a new round ordinal

_ON = False               # spans and counters on: recording, not muted
_LOG: Optional["SpanLog"] = None   # the log being written
_NULL = contextlib.nullcontext()


class Record:
    """One span (or note) of a log: its name, the index of its parent
    record (None at the top), the ordinal of its round in the recording
    (None outside any round), its host ms (None inside a capture or on a
    note without one), its device ms (None without the device clock) and
    a note's extra numbers."""
    __slots__ = ("name", "parent", "round", "host_ms", "device_ms", "events",
                 "info")

    def __init__(self, name, parent, rnd, info=None):
        self.name, self.parent, self.round = name, parent, rnd
        self.host_ms = self.device_ms = self.events = None
        self.info = info


class SpanLog:
    """What a recording holds: its records in the order they opened, the
    counters' values (name, round, value) and the number of rounds.
    ``device_clock``: whether spans record timing events (on the card)."""

    def __init__(self, device_clock: bool, capture: bool = False):
        self.device_clock = device_clock
        self.capture = capture         # a captured chunk's (captured())
        self.records: List[Record] = []
        self.open: List[int] = []      # the open spans' record indices
        self.counts: list = []
        self.rounds = 0
        self.last_event = None

    def _current_round(self):
        return self.records[self.open[-1]].round if self.open else None

    def _resolve(self) -> None:
        """Turn every pair of events into device ms (waits for them)."""
        for r in self.records:
            if r.events is None:
                continue
            start, end = r.events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            r.events = None

    def counter(self, name: str) -> float:
        """The sum of every value counted under ``name``."""
        total = 0.0
        for n, _, v in self.counts:
            if n == name:
                total += float(v.sum()) if isinstance(v, torch.Tensor) \
                    else float(v)
        return total

    def by_round(self, name: str) -> Dict[int, float]:
        """Device ms (host ms without the device clock) of the spans named
        ``name``, summed by round ordinal."""
        self._resolve()
        out: Dict[int, float] = {}
        for r in self.records:
            ms = r.device_ms if r.device_ms is not None else r.host_ms
            if r.name == name and r.round is not None and ms is not None:
                out[r.round] = out.get(r.round, 0.0) + ms
        return out

    def summary(self) -> dict:
        """By span name: ``calls``, ``device_ms``, ``self_device_ms`` (the
        spans less what their children cover), ``host_ms`` (None where no
        call had a host time) and a note's numbers summed; the counters'
        sums; the rounds."""
        self._resolve()
        child = [0.0] * len(self.records)
        for r in self.records:
            if r.parent is not None and r.device_ms is not None:
                child[r.parent] += r.device_ms
        spans: Dict[str, dict] = {}
        for i, r in enumerate(self.records):
            s = spans.setdefault(r.name, {"calls": 0, "device_ms": None,
                                          "self_device_ms": None,
                                          "host_ms": None})
            s["calls"] += 1
            if r.device_ms is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
                s["self_device_ms"] = ((s["self_device_ms"] or 0.0)
                                       + r.device_ms - child[i])
            if r.host_ms is not None:
                s["host_ms"] = (s["host_ms"] or 0.0) + r.host_ms
            for k, v in (r.info or {}).items():
                if isinstance(v, (int, float)):
                    s[k] = s.get(k, 0.0) + v
        names = dict.fromkeys(n for n, _, _ in self.counts)
        return {"spans": spans,
                "counters": {n: self.counter(n) for n in names},
                "rounds": self.rounds}


class _Span:
    __slots__ = ("name", "fn", "log", "index", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> int:
        log = self.log = _LOG
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        parent = log.open[-1] if log.open else None
        if self.name == ROUND:
            rnd = log.rounds
            log.rounds += 1
        else:
            rnd = log.records[parent].round if parent is not None else None
        rec = Record(self.name, parent, rnd)
        self.index = len(log.records)
        log.records.append(rec)
        log.open.append(self.index)
        capturing = log.device_clock and \
            torch.cuda.is_current_stream_capturing()
        if log.device_clock:
            start = torch.cuda.Event(enable_timing=True, external=capturing)
            end = torch.cuda.Event(enable_timing=True, external=capturing)
            start.record()
            rec.events = (start, end)
        self.t0 = None if capturing else time.perf_counter()
        return self.index

    def __exit__(self, *exc) -> None:
        log = self.log
        rec = log.records[self.index]
        if rec.events is not None:
            rec.events[1].record()
            log.last_event = rec.events[1]
        if self.t0 is not None:
            rec.host_ms = (time.perf_counter() - self.t0) * 1e3
        log.open.pop()
        self.fn.__exit__(*exc)


def span(name: str, eager_only: bool = False):
    """A context manager around one phase; entering it gives the span's
    record index when on, None when off. An ``eager_only`` span (the
    nested ones: ``local.*``, ``exchange.*``) is left out of a captured
    chunk, whose every event is a node of the graph."""
    if not _ON or (eager_only and _LOG.capture):
        return _NULL
    return _Span(name)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor whose elements are summed when
    the log is read) to the counter ``name``."""
    if not _ON:
        return
    _LOG.counts.append((name, _LOG._current_round(), value))


def note(name: str, host_ms: float, **info) -> None:
    """A host-only record of a time measured elsewhere (set-up), with its
    extra numbers. Kept while a recording is open, muted or not."""
    if _LOG is None:
        return
    parent = _LOG.open[-1] if _LOG.open else None
    rec = Record(name, parent, _LOG._current_round(), info)
    rec.host_ms = host_ms
    _LOG.records.append(rec)


def on() -> bool:
    """True while spans record."""
    return _ON


@contextlib.contextmanager
def recording(device_clock: Optional[bool] = None):
    """Turn spans on for the block and yield the :class:`SpanLog` they
    fill. ``device_clock`` (default: a card is present) records timing
    events on the current stream."""
    global _ON, _LOG
    if device_clock is None:
        device_clock = torch.cuda.is_available()
    prev = (_ON, _LOG)
    log = SpanLog(device_clock)
    _ON, _LOG = True, log
    try:
        yield log
    finally:
        _ON, _LOG = prev


@contextlib.contextmanager
def muted():
    """Spans and counters off for the block (notes still kept): a round
    run only to build what a capture needs is no round of the log."""
    global _ON
    prev, _ON = _ON, False
    try:
        yield
    finally:
        _ON = prev


@contextlib.contextmanager
def captured():
    """Around a CUDA graph capture: the spans the captured rounds open go
    to a log of their own, yielded (None when spans are off), whose events
    every replay of the graph records again; :func:`replayed` reads them."""
    global _LOG
    if not _ON:
        yield None
        return
    prev = _LOG
    tpl = _LOG = SpanLog(prev.device_clock, capture=True)
    try:
        yield tpl
    finally:
        _LOG = prev


def replayed(tpl: Optional[SpanLog], parent: Optional[int] = None) -> None:
    """After a replay of a graph captured with spans on: wait for its last
    event and add each captured span's device ms, and each captured
    counter's value, to the open log, the captured rounds numbered after
    the log's own, top-level spans under ``parent``."""
    if tpl is None or _LOG is None:
        return
    log = _LOG
    if tpl.last_event is not None:
        tpl.last_event.synchronize()
    first = log.rounds
    at: Dict[int, int] = {}
    for i, r in enumerate(tpl.records):
        if r.events is None:       # a note: nothing the replay timed
            continue
        at[i] = len(log.records)
        rec = Record(r.name, at.get(r.parent, parent),
                     None if r.round is None else first + r.round)
        rec.device_ms = r.events[0].elapsed_time(r.events[1])
        log.records.append(rec)
    for name, rnd, v in tpl.counts:
        log.counts.append((name, None if rnd is None else first + rnd,
                           v.clone() if isinstance(v, torch.Tensor) else v))
    log.rounds += tpl.rounds
