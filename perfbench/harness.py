"""One run of one cell: set-up, the check rounds, the measured window (or
the traced one), the reference's recomputation, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json`` (which names its plain
reference under ``reference/`` and its program side under ``adapters/``),
its traffic mix in ``workloads/<traffic>.json``, the limits of its
comparison in ``limits/<cell>.json``, and each per-layer metric in
``metrics/<metric>.py``.

The run:

1. makes the federation's data and the initial model on the device from
   the seed, builds the program's algorithm and state from them;
2. drives the first rounds through the window's own call (the check
   rounds), which also builds every kernel and captures every graph, and
   copies the state they leave to the host; where a call is one round,
   the server after the first round too, and that round's local steps as
   a wrapper of the program's loss records them (removed before the
   window);
3. measures: ``--trace 0`` a closed loop of the window's call for
   ``--seconds``, timed by the host's clock around a synchronised run;
   ``--trace 1`` ``trace_rounds`` rounds under ``torch.profiler``;
4. reads the memory peak, frees the program, and has the reference follow
   the check rounds from the same inputs and draws;
5. prints the compared numbers with their limits as the last lines of
   standard error, and the result as the last line of standard output.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import torch

from perfbench import compare, counts
from perfbench.reference import precision
from perfbench.reference import quafl as ref_quafl
from perfbench.traffic import generate

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoChip(RuntimeError):
    """The cell asks for cards this machine does not have."""


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one of the run's streams."""
    h = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark found by its file name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files read; ``bench`` is the
    benchmark's folder, where every file is found by name."""
    bench: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def reference(self):
        return load_module(self.bench / "reference"
                           / f"{self.config['reference']}.py",
                           f"perfbench.reference.{self.config['reference']}")

    def metric(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py",
                           f"perfbench.metrics.{name}")

    @property
    def adapter(self):
        return load_module(self.bench / "adapters"
                           / f"{self.config['adapter']}.py",
                           f"perfbench.adapters.{self.config['adapter']}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    bench = root / "perfbench"
    return Cell(
        bench=bench, name=name, chips=int(w["chips"]),
        config=load_json(bench / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench / "workloads" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])


def require_chips(n: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: this benchmark measures the card and "
                     "has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise NoChip(f"the cell asks for {n} cards; "
                     f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_weights(leaves, seed: int, dev) -> torch.Tensor:
    """The flat initial model: one normal draw on the device, scaled leaf
    by leaf to N(0, scale^2) (scale 0: zeros)."""
    d = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(d, generator=gen, device=dev)
    off = 0
    for _, shape, scale in leaves:
        n = math.prod(shape)
        x[off:off + n].mul_(scale)
        off += n
    return x


def views(x: torch.Tensor, leaves) -> dict:
    out, off = {}, 0
    for name, shape, _ in leaves:
        n = math.prod(shape)
        out[name] = x[off:off + n].view(shape)
        off += n
    return out


def smi() -> str:
    """The card's clocks, power and limit, or why they could not be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def peak_flops(cfg: dict) -> float:
    if cfg["compute_dtype"] == "float32":
        return counts.PEAK_FLOPS["tf32" if torch.backends.cuda.matmul
                                 .allow_tf32 else "float32"]
    return counts.PEAK_FLOPS[cfg["compute_dtype"]]


@dataclass
class TraceCtx:
    """What a per-layer metric reads: the traced window's device
    operations (name, start us, end us), its rounds and length, and the
    counts of its work."""
    kernels: list
    host: list
    rounds: int
    window_s: float
    exchange_bytes_per_round: float
    model_flops: float
    peak_flops: float
    device_name: str


def busy_seconds(kernels) -> float:
    """The union of the device operations' intervals, in seconds."""
    total, end = 0.0, -math.inf
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def idle_gaps(kernels, host, top: int = 10):
    """The longest gaps between device operations, each named by the
    innermost host operation running at its middle."""
    gaps, end = [], None
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    out = []
    for length, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inside = [h for h in host if h[1] <= mid <= h[2]]
        name = (min(inside, key=lambda h: h[2] - h[1])[0] if inside
                else "no host op")
        out.append([f"host:{name}", length * 1e-6])
    return out


def device_ops(kernels, top: int = 10):
    tot = {}
    for name, a, b in kernels:
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def profiled(fn, dev, host: bool):
    """``fn()`` under torch.profiler: (its result, the traced window's
    host seconds, device operations, host operations). Host operations are
    recorded only when ``host``: recording them slows a launch-bound
    round several fold."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if host or dev.type != "cuda" else []
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        window = time.perf_counter() - t0
    dev_ops, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ops.append(row)
        else:
            host.append(row)
    return out, window, dev_ops, host


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    dev: torch.device
    obs: dict = field(default_factory=dict)


def leaves_of(cell: Cell):
    return cell.reference.leaves(cell.config)


def reference_state(cell: Cell, data, x0, draw_seed: int, rounds: int,
                    mode: str = "float32", fault=None, sample=None):
    """The reference's state after ``rounds`` rounds from ``x0``, with the
    round's draws from a generator seeded ``draw_seed``; with ``sample``
    (:func:`compare.sample_indices`) its first round's local steps are
    recorded too, as ``first_steps``."""
    tr = cell.traffic
    fed = ref_quafl.Federation(n=tr["n_clients"], s=tr["s"],
                               K=tr["local_steps"], lr=tr["lr"],
                               batch=tr["batch"], bits=tr["bits"],
                               swt=tr["swt"], sit=tr["sit"])
    probe = (None if sample is None
             else compare.FirstSteps(sample, tr["local_steps"]))
    progress = cell.reference.make_progress(
        cell.config, data, tr["lr"], mode, fault,
        **({} if probe is None else {"probe": probe}))
    st = ref_quafl.State(x0, fed)
    gen = torch.Generator(device=x0.device)
    gen.manual_seed(draw_seed)
    for r in range(rounds):
        ref_quafl.one_round(st, fed, generate.pool_size(tr), gen, progress,
                            fault)
        if r == 0:
            st.first_server = st.server.to("cpu", copy=True)
            if probe is not None:
                probe.on = False
                st.first_steps = probe.host([k for k, _, _ in
                                             leaves_of(cell)])
    return st


def execute(run: Run, plant=None) -> dict:
    """One run of the cell; returns the result dict. ``plant``, a test's
    hook, is called with the program's algorithm before the first round."""
    cell, dev = run.cell, run.dev
    tr, cfg = cell.traffic, cell.config
    leaves = leaves_of(cell)
    data_seed = sub_seed(run.seed, "data")
    weight_seed = sub_seed(run.seed, "weights")
    draw_seed = tr["draw_seed"]
    from perfbench.adapters import common
    cold = not any((cell.bench.parent / "build" / "repro_torch")
                   .glob("*.so"))

    # 1. inputs and the system under test
    data = generate.make(tr, cfg, data_seed, dev)
    fed = common.fed_config(tr)
    x0 = make_weights(leaves, weight_seed, dev)
    alg = cell.adapter.build(cfg, tr, leaves, dev, fed)
    if plant is not None:
        plant(alg)
    state = alg.init(views(x0, leaves))
    del x0
    gen = torch.Generator(device=dev)
    gen.manual_seed(draw_seed)
    call = common.WindowCall(alg, data, gen, tr["engine_chunk"])
    per_step = call.rounds_per_step
    check_steps = -(-tr["check_rounds"] // per_step)

    # 2. the check rounds, through the window's call; where a step is one
    # round, the server after the first and its local steps are kept
    first, steps, snap_s = None, None, 0.0
    sample = probe = None
    if per_step == 1:
        sample = compare.sample_indices(leaves, sub_seed(run.seed, "sample"),
                                        dev)
        probe = common.LossProbe(alg, compare.FirstSteps(
            sample, tr["local_steps"]))
    for i in range(check_steps):
        state, _ = call.step(state)
        if i == 0 and probe is not None:
            probe.remove()
            sync(dev)
            t_snap = time.perf_counter()
            first = state.server.detach().to("cpu", copy=True)
            steps = probe.rec.host([k for k, _, _ in leaves])
            snap_s += time.perf_counter() - t_snap
    sync(dev)
    t_snap = time.perf_counter()
    snap = common.snapshot(state)
    snap["first_server"], snap["first_steps"] = first, steps
    snap_s += time.perf_counter() - t_snap
    setup_s = time.perf_counter() - run.t_start - snap_s
    run.obs.update(cold_build=cold, setup_s=setup_s, snapshot_s=snap_s,
                   check_rounds=check_steps * per_step)

    # 3. the window
    rows = tr["batch"]
    flops_row = cell.reference.flops_per_row(cfg, tr)
    hs: list = []
    run.obs["smi_before"] = smi() if dev.type == "cuda" else "cpu"
    if run.trace:
        n_steps = -(-tr["trace_rounds"] // per_step)

        def traced():
            nonlocal state
            for _ in range(n_steps):
                state, h = call.step(state)
                hs.append(h)
        _, window_s, kernels, _ = profiled(traced, dev, host=False)
        rounds = n_steps * per_step

        def one():
            nonlocal state
            state, _ = call.step(state)
        _, _, gap_kernels, host = profiled(one, dev, host=True)
    else:
        rounds = 0
        sync(dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            state, h = call.step(state)
            hs.append(h)
            rounds += per_step
        sync(dev)
        window_s = time.perf_counter() - t0
    run.obs["smi_after"] = smi() if dev.type == "cuda" else "cpu"
    active = float(torch.cat(hs).sum()) * tr["s"]
    model_flops = active * rows * flops_row
    peak = peak_flops(cfg)
    mem_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        raise ImportError(f"modules of the JAX package or JAX loaded: "
                          f"{found}")

    # 4. the reference follows the check rounds
    del state, hs
    common.release(call)
    del call, alg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    precision.fp32_only()
    t_ref = time.perf_counter()
    x0 = make_weights(leaves, weight_seed, dev)
    run.obs["held_after_release_bytes"] = (
        torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0)
    ref = reference_state(cell, data, x0, draw_seed, check_steps * per_step,
                          sample=sample)
    nums = compare.numbers(snap, compare.state_dict(ref), x0, leaves)
    run.obs["reference_s"] = time.perf_counter() - t_ref
    if dev.type == "cuda":
        run.obs["peak_after_reference_bytes"] = \
            torch.cuda.max_memory_allocated(dev)
    del snap
    run.obs["leaf_gaps"] = nums.pop("leaf_gaps")
    run.obs["numbers"] = nums
    correct, checks = compare.verdict(nums, cell.limits)

    # 5. the result
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": name, "count": cell.chips,
              "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": rounds, "failed": 0}
    if run.trace:
        ctx = TraceCtx(kernels=kernels, host=host, rounds=rounds,
                       window_s=window_s,
                       exchange_bytes_per_round=counts.exchange_bytes(
                           sum(math.prod(s) for _, s, _ in leaves), tr["s"]),
                       model_flops=model_flops, peak_flops=peak,
                       device_name=name)
        device["busy_s"] = busy_seconds(kernels)
        device["window_s"] = window_s
        metrics = {}
        for m in cell.per_layer:
            v = cell.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device
        result["breakdown"] = {"device_ops": device_ops(kernels),
                               "idle_gaps": idle_gaps(gap_kernels, host)}
    else:
        values = {"rounds_per_s": rounds / window_s,
                  "mfu": 100.0 * model_flops / (window_s * peak),
                  "peak_mem_gb": mem_peak / 1e9,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device
    run.obs["window_s"] = window_s
    run.obs["rounds"] = rounds
    result["checks"] = checks
    return result
