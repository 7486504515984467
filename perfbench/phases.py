"""Where a cell's rounds go, by the program's own spans
(``repro_torch.utils.spans``): the phase split on the device clock, what
recording the spans costs, idle gaps put down to the span the host was in,
the set-up's parts, and bits with spans on against spans off.

    python3 perfbench/phases.py --workload olmo1b_quafl_b8 --seed 7 \\
        --steps 4 --windows 3

It builds the cell as ``run.py`` does (data, weights, traffic and the
window's call, found by name, on the card), then:

1. set-up with spans recording (``quafl.init``) and muted through the
   first step (the notes ``build.load``, ``engine.warmup``,
   ``engine.capture``, ``engine.instantiate``): ``setup_spans``;
2. with ``--bits``, one step from one copy of the state with spans off, on
   and off again: whether the states and bits are equal;
3. ``--windows`` pairs of timed windows of ``--steps`` steps, spans off
   then on (the spans' chunk captured before, untimed), host clock
   around a synchronised loop: the cost of the spans;
4. the phase split of the spans-on windows: the four numbers of
   :func:`phase_metrics`, the spans' summary and each round's phases;
5. the kernel pass: ``--steps`` steps under ``torch.profiler`` (device
   activity, spans off), read by the cell's per-layer metrics of
   ``metrics/``, as a traced run reads them;
6. the gap step: one step with spans on under the profiler with host
   activity; each idle gap put down to the innermost span running on the
   host at its middle (:func:`idle_by_span`), and that step's span ms
   beside its kernel families' ms;
7. with ``--long`` seconds, spans-on windows of captured chunks, each
   right after a fresh capture (``--captures`` of them): each chunk's
   replay interval and its rounds' phases, written to ``<--out>/long.json``
   when ``--out`` names a directory.

Prints one JSON line. The four numbers of :func:`phase_metrics` are what
the per-layer metrics ``local_ms_per_round``, ``flat_ms_per_round``,
``exchange_phase_ms_per_round`` and ``local_active_share`` would read;
``harness.py`` does not run these passes (``PERF.md`` §7).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    for _var, _dir in {"TORCH_EXTENSIONS_DIR": "torch_extensions",
                       "TRITON_CACHE_DIR": "triton",
                       "CUDA_CACHE_PATH": "nv_compute"}.items():
        os.environ[_var] = str(ROOT / "build" / _dir)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

# the phases the round's five children partition it into, and which of
# them each ms number sums
PHASES = ("quafl.cohort", "quafl.local", "quafl.progress", "quafl.exchange",
          "quafl.commit")
FLAT = ("quafl.cohort", "quafl.progress", "quafl.commit")


def phase_metrics(summary: dict) -> dict:
    """The four per-layer numbers of a spans summary
    (``SpanLog.summary``): device ms a round inside ``quafl.local``, inside
    the flat passes (cohort + progress + commit) and inside
    ``quafl.exchange`` (None without the device clock), and the active
    share of the local steps computed, in percent."""
    sp, rounds = summary["spans"], summary["rounds"]

    def ms(*names):
        vals = [sp.get(n, {}).get("device_ms") for n in names]
        if not rounds or any(v is None for v in vals):
            return None
        return sum(vals) / rounds

    c = summary["counters"]
    computed = c.get("local.steps_computed", 0.0)
    return {"local_ms_per_round": ms("quafl.local"),
            "flat_ms_per_round": ms(*FLAT),
            "exchange_phase_ms_per_round": ms("quafl.exchange"),
            "local_active_share": (100.0 * c.get("local.steps_active", 0.0)
                                   / computed if computed else None)}


def coverage(log) -> dict:
    """The least share of a round's device interval its five phases cover,
    and of a replay's the rounds inside it cover (None where there are
    none)."""
    recs = log.records
    kids: dict = {}
    for r in recs:
        if r.parent is not None and r.device_ms is not None:
            kids.setdefault(r.parent, []).append(r)

    def least(name, child):
        shares = [sum(k.device_ms for k in kids.get(i, ())
                      if k.name in child) / r.device_ms
                  for i, r in enumerate(recs)
                  if r.name == name and r.device_ms]
        return min(shares) if shares else None
    return {"phases_of_round": least("quafl.round", PHASES),
            "rounds_of_replay": least("engine.replay", ("quafl.round",))}


def idle_by_span(kernels, host, names, top: int = 10) -> dict:
    """Every gap between device operations put down to the innermost span
    (a host range named in ``names``) running at its middle, as
    ``harness.idle_gaps`` names gaps: the ``top`` spans by idle seconds
    ([[span, s], ...]), the idle seconds in all and the share of them put
    down to a span."""
    from perfbench.harness import idle_gaps
    ranges = [h for h in host if h[0] in names]
    by: dict = {}
    for name, sec in idle_gaps(kernels, ranges, top=len(kernels)):
        name = name[len("host:"):]
        name = "no span" if name == "no host op" else name
        by[name] = by.get(name, 0.0) + sec
    total = sum(by.values())
    return {"idle_by_span": [[k, v] for k, v in sorted(
                by.items(), key=lambda kv: -kv[1])[:top]],
            "idle_s": total,
            "named_share": ((total - by.get("no span", 0.0)) / total
                            if total else None)}


def host_copy(state):
    from repro_torch.fed.engine import _leaves
    return [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else x for x in _leaves(state)]


def restore(like, host, dev):
    """A fresh state of ``like``'s form from a :func:`host_copy`."""
    from repro_torch.fed.engine import _rebuild
    return _rebuild(like, iter([h.to(dev, copy=True)
                                if isinstance(h, torch.Tensor)
                                else h for h in host]))


class Cell:
    """A cell's program, built as ``harness.execute`` builds it."""

    def __init__(self, cell, seed: int, dev):
        from perfbench import harness
        from perfbench.adapters import common
        from perfbench.traffic import generate
        from repro_torch.utils import spans
        self.cell, self.dev = cell, dev
        tr, cfg = cell.traffic, cell.config
        self.leaves = harness.leaves_of(cell)
        data = generate.make(tr, cfg, harness.sub_seed(seed, "data"), dev)
        x0 = harness.make_weights(self.leaves,
                                  harness.sub_seed(seed, "weights"), dev)
        with spans.recording(device_clock=dev.type == "cuda") as log:
            t0 = time.perf_counter()
            self.alg = cell.adapter.build(cfg, tr, self.leaves, dev,
                                          common.fed_config(tr))
            build_s = time.perf_counter() - t0
            self.state = self.alg.init(harness.views(x0, self.leaves))
            del x0
            self.gen = torch.Generator(device=dev)
            self.gen.manual_seed(tr["draw_seed"])
            self.call = common.WindowCall(self.alg, data, self.gen,
                                          tr["engine_chunk"])
            with spans.muted():
                t0 = time.perf_counter()
                self.state, _ = self.call.step(self.state)
                harness.sync(dev)
                first_s = time.perf_counter() - t0
        self.setup = {"spans": log.summary()["spans"], "build_s": build_s,
                      "first_step_s": first_s}
        self.per_step = self.call.rounds_per_step

    def step(self, hs=None):
        self.state, h = self.call.step(self.state)
        if hs is not None:
            hs.append(h)

    def steps(self, n: int, hs=None) -> float:
        """``n`` steps, timed by the host around a synchronised loop."""
        from perfbench import harness
        harness.sync(self.dev)
        t0 = time.perf_counter()
        for _ in range(n):
            self.step(hs)
        harness.sync(self.dev)
        return time.perf_counter() - t0

    def bits(self) -> dict:
        """One step from one copy of the state and generator, spans off,
        on, off: whether each pair of results is equal."""
        from repro_torch.fed.engine import _leaves, _rebuild
        from repro_torch.utils import spans
        saved, g0 = host_copy(self.state), self.gen.get_state()
        # the state's form, its leaves on the host: no second copy of it
        # stays on the card
        like = _rebuild(self.state, iter(saved))
        first, equal = None, []
        for on in (False, True, False):
            self.state = None
            self.state = restore(like, saved, self.dev)
            self.gen.set_state(g0)
            if on:
                with spans.recording(device_clock=self.dev.type == "cuda"):
                    self.step()
            else:
                self.step()
            if first is None:
                first = host_copy(self.state)
            else:
                # leaf by leaf, so that one more copy at most is on the host
                equal.append(all(
                    torch.equal(x.detach().to("cpu"), y)
                    if isinstance(x, torch.Tensor) else x == y
                    for x, y in zip(_leaves(self.state), first)))
        return {"on_equals_off": equal[0], "off_equals_off": equal[1]}


def quartile_spread(xs):
    if len(xs) < 2:
        return None
    q = statistics.quantiles(xs, n=4)
    return (q[2] - q[0]) / statistics.median(xs)


def run(cell, seed: int, dev, steps: int, windows: int, check_bits: bool,
        long_s: float = 0.0, captures: int = 1, out_dir=None) -> dict:
    """The passes of the module docstring on a built cell; returns the
    result dict."""
    from perfbench import counts, harness
    from repro_torch.utils import spans
    c = Cell(cell, seed, dev)
    tr, cfg = cell.traffic, cell.config
    clock = dev.type == "cuda"
    res = {"cell": cell.name, "seed": seed, "device": (
        torch.cuda.get_device_name(dev) if clock else "cpu"),
        "smi": harness.smi() if clock else "cpu",
        "rounds_per_step": c.per_step, "steps": steps,
        "setup": c.setup}
    if check_bits:
        res["bits"] = c.bits()
    # the spans' own chunk (a graph of its own where the call captures),
    # made before any timed window
    with spans.recording(device_clock=clock):
        c.step()
    rates = {"off": [], "on": []}
    logs, shares = [], []
    for _ in range(windows):
        rates["off"].append(steps * c.per_step / c.steps(steps))
        hs = []
        with spans.recording(device_clock=clock) as log:
            rates["on"].append(steps * c.per_step / c.steps(steps, hs))
        logs.append(log)
        shares.append(100.0 * float(torch.cat(hs).mean())
                      / tr["local_steps"])
    res["rounds_per_s"] = rates
    med = {k: statistics.median(v) for k, v in rates.items()}
    res["spans_on_cost"] = 1.0 - med["on"] / med["off"]
    res["spread"] = {k: quartile_spread(v) for k, v in rates.items()}
    summaries = [lg.summary() for lg in logs]
    res["phase_metrics"] = [phase_metrics(s) for s in summaries]
    res["round_ms"] = [(s["spans"]["quafl.round"]["device_ms"]
                        or s["spans"]["quafl.round"]["host_ms"])
                       / s["rounds"] for s in summaries]
    res["h_steps_share"] = shares       # 100·mean(H)/K, by window
    res["spans"] = summaries[0]["spans"]
    res["counters"] = summaries[0]["counters"]
    res["coverage"] = [coverage(lg) for lg in logs]
    res["per_round"] = {p: list(logs[0].by_round(p).values())[:40]
                        for p in ("quafl.round",) + PHASES}

    # the kernel pass: spans off, as a traced run of run.py
    hs = []
    _, window_s, kernels, _ = harness.profiled(
        lambda: c.steps(steps, hs), dev, host=False)
    rounds = steps * c.per_step
    d = sum(math.prod(s) for _, s, _ in c.leaves)
    active = float(torch.cat(hs).sum()) * tr["s"]
    ctx = harness.TraceCtx(
        kernels=kernels, host=[], rounds=rounds, window_s=window_s,
        exchange_bytes_per_round=counts.exchange_bytes(d, tr["s"]),
        model_flops=active * tr["batch"]
        * cell.reference.flops_per_row(cfg, tr),
        peak_flops=harness.peak_flops(cfg), device_name=res["device"])
    res["kernel_pass"] = {m["name"]: cell.metric(m["name"]).read(ctx)
                          for m in cell.per_layer}
    res["kernel_pass"]["busy_s"] = harness.busy_seconds(kernels)
    res["kernel_pass"]["window_s"] = window_s

    # the gap step: spans on under the profiler with host activity
    with spans.recording(device_clock=clock) as log:
        _, gap_s, gap_kernels, host = harness.profiled(c.step, dev,
                                                       host=True)
    summ = log.summary()
    names = set(summ["spans"])
    n_all = len(gap_kernels)
    gap_kernels = [k for k in gap_kernels if k[0] not in names]
    res["gap_step"] = idle_by_span(gap_kernels, host, names)
    res["gap_step"]["window_s"] = gap_s
    res["gap_step"]["busy_s"] = harness.busy_seconds(gap_kernels)
    fams = {}
    for fam in ("exchange_ms_per_round", "model_kernels_ms_per_round",
                "other_kernels_ms_per_round"):
        member = cell.metric(fam).member
        fams[fam] = (sum(b - a for n, a, b in gap_kernels if member(n))
                     * 1e-3 / max(summ["rounds"], 1))
    res["gap_step"]["kernel_ms_per_round"] = fams
    res["gap_step"]["phase_metrics"] = phase_metrics(summ)
    res["gap_step"]["user_annotations_dropped"] = n_all - len(gap_kernels)

    if long_s > 0 and c.call.engine is not None:
        res["long"] = long_window(c, long_s, captures, clock, out_dir)
    return res


def long_window(c, seconds: float, captures: int, clock: bool,
                out_dir) -> dict:
    """``captures`` fresh captures of the chunk with spans on, each
    replayed for ``seconds`` / ``captures`` right after it is made: every
    chunk's replay interval, its rounds' device ms and their phases',
    written out whole; returned, the chunks split where their rounds' ms
    cross the midpoint of the fastest and the slowest tenth, with each
    number's mean in either part."""
    from repro_torch.fed.engine import RoundEngine
    from repro_torch.utils import spans
    rows = {"capture": [], "replay_ms": [], "rounds_ms": [],
            **{p: [] for p in PHASES}}
    for k in range(captures):
        c.call.engine = RoundEngine(c.alg)
        with spans.recording(device_clock=clock) as log:
            c.step()                       # the capture, then one replay
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds / captures:
                c.step()
        log.summary()
        recs, at = log.records, {}
        for i, r in enumerate(recs):
            if r.name == "engine.replay":
                at[i] = len(rows["replay_ms"])
                rows["capture"].append(k)
                rows["replay_ms"].append(r.device_ms)
                for n in ["rounds_ms", *PHASES]:
                    rows[n].append(0.0)
        for r in recs:
            if r.name == "quafl.round" and r.parent in at:
                rows["rounds_ms"][at[r.parent]] += r.device_ms
            elif r.name in PHASES and recs[r.parent].parent in at:
                rows[r.name][at[recs[r.parent].parent]] += r.device_ms
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "long.json").write_text(json.dumps(rows))
    srt = sorted(rows["rounds_ms"])
    k = max(len(srt) // 10, 1)
    cut = 0.5 * (statistics.mean(srt[:k]) + statistics.mean(srt[-k:]))
    out = {"chunks": len(srt), "cut_ms": cut,
           "deciles": statistics.quantiles(srt, n=10)}
    for part, keep in (("fast", lambda x: x <= cut),
                       ("slow", lambda x: x > cut)):
        idx = [i for i, x in enumerate(rows["rounds_ms"]) if keep(x)]
        out[part] = {"chunks": len(idx),
                     "captures": sorted({rows["capture"][i] for i in idx}),
                     **{n: (statistics.mean(rows[n][i] for i in idx)
                            if idx else None)
                        for n in rows if n != "capture"}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=0,
                    help="steps a window (default: trace_rounds' steps)")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--bits", type=int, choices=(0, 1), default=1)
    ap.add_argument("--long", type=float, default=0.0)
    ap.add_argument("--captures", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    from perfbench import harness
    cell = harness.find_cell(ROOT, args.workload)
    try:
        dev = harness.require_chips(cell.chips)
    except harness.NoChip as e:
        print(f"phases: {e}", file=sys.stderr)
        return 2
    tr = cell.traffic
    steps = args.steps or -(-tr["trace_rounds"] // max(tr["engine_chunk"],
                                                       1))
    res = run(cell, args.seed, dev, steps, args.windows, bool(args.bits),
              args.long, args.captures, args.out)
    res["wall_s"] = time.perf_counter() - T_START
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
