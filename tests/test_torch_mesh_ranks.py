"""The mesh train step on 8 ranks: the port under gloo (one
``torch.multiprocessing.spawn`` of 8 processes running
``tests/mesh_ranks_worker.py``, a ``file://`` rendezvous under
``tmp_path``) against the JAX reference on 8 XLA host devices (one
subprocess), at reduced llama3.2-1b:

* (4, 2) data×model, client_dp, every transport; (2, 2, 2) pod×data×model,
  cohort, ``shard_local``; the reference runs one program for each check
  (``mesh_ranks_worker.CASES``): the whole step of each family and mode,
  and the shard-local exchange alone for each of its client sums;
* the same inputs (state, tokens, key) on both sides; the reference's
  draws injected into each port rank (``tests/test_torch_harness.py``);
* the port's own streams for the pins between its transports;
* one ``torchrun --nproc-per-node 2`` run of ``launch/train.py --algo spmd
  --mesh-data 2 --device cpu``.

Tolerances (``tests/test_torch_spmd.py``'s, and the reference's own pins
in ``tests/test_distributed.py``):
* a whole step: the server and the clients within ‖Δ‖/‖X_{t+1}‖ ≤ 1e-4
  per leaf, ``quant_err_sq`` within 1e-4 relative, each plus what the
  codes at a rounding boundary (y/γ + u within 1e-4 of an integer) could
  move by rounding the other way (``test_torch_harness.flip_slack``);
* the shard-local exchange alone: every code equal to the reference's
  encode of the same inputs but for counted ±1 flips at a boundary;
  servers and clients within rtol = atol = 2e-5, ``qerr`` within 1e-5
  relative, each plus what the counted flips move;
* the port's pins: ``shard_local`` against ``shard_local_codes`` within
  2e-5; ``shard_local_rs`` against ``shard_local`` under 0.25 per leaf
  and 0.02 over the model.
"""
import os
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mesh_ranks_worker import (ARCH, B, CASES, K, LR, REFERENCE_OF, SEQ,
                               SHARD_LOCAL, case_name, make_step,
                               reference_name, run_rank)
from test_torch_harness import (LatticeLog, flip_slack, lattice_candidates,
                                lattice_flips, leaf_stats, npy,
                                reference_step_draws)
from repro_torch.sharding.rules import join_blocks

ROOT = Path(__file__).resolve().parent.parent
SRV_TOL, EX_TOL, QERR_TOL, QERR_STEP_TOL = 1e-4, 2e-5, 1e-5, 1e-4

REFERENCE = r"""
import os, sys
# 8 host devices; each runs its ops on one thread (the suite's workers
# share the machine's cores)
# (LLVM's cheap pipeline: the programs compile in 60%% of the CPU time)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
sys.path.insert(0, sys.argv[2])
import test_torch_harness  # noqa: F401  (the jax.core alias)
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp, numpy as np
from repro.compression.codecs import resolve_codec
from repro.compression.transports import transport_for_mode
from repro.configs import get_reduced
from repro.configs.base import FedConfig, ShapeConfig
from repro.core.exchange_local import make_shardlocal_exchange
from repro.launch.steps import TrainState, build_train_step
from repro.models.model import abstract_lm
from repro.sharding.rules import pspec_for, rules_for_mode
from repro.utils.compat import make_mesh
out = sys.argv[1]
cfg = get_reduced("llama3.2-1b")
jobs = []      # (case name, output prefix, mesh, jitted fn, args)
for name, case in sorted(np.load(out + "/cases.npz", allow_pickle=True)
                         ["cases"].item().items()):
    shape, axes, mode, tr, whole, alone = case
    inp = np.load(out + f"/in_{name}.npz")
    mesh = make_mesh(shape, axes)
    fed = FedConfig(local_steps=%d, lr=%r, bits=8, transport=tr)
    n = int(inp["n"])
    srv = {k[4:]: jnp.asarray(inp[k]) for k in inp if k.startswith("srv/")}
    cl = {k[3:]: jnp.asarray(inp[k]) for k in inp if k.startswith("cl/")}
    with mesh:
        step, spec, sh = build_train_step(
            cfg, fed, mesh, ShapeConfig("t", %d, %d * n, "train"),
            fed_mode=mode, transport=tr, remat=False)
        st = TrainState(server=srv, clients=cl, t=jnp.zeros((), jnp.int32))
        if whole:
            jobs.append((name, "", mesh, jax.jit(step, in_shardings=sh),
                         (st, {"tokens": jnp.asarray(inp["toks"])},
                          jnp.asarray(inp["key"]))))
        if alone:
            ys = {k[3:]: jnp.asarray(inp[k]) for k in inp
                  if k.startswith("ys/")}
            rules = rules_for_mode(mode)
            sp, ax = abstract_lm(cfg)
            srv_ps = {k: pspec_for(v.shape, ax[k], rules, mesh)
                      for k, v in sp.items()}
            cl_ps = {k: pspec_for((n,) + tuple(v.shape),
                                  ("clients",) + tuple(ax[k]), rules, mesh)
                     for k, v in sp.items()}
            ex = make_shardlocal_exchange(
                resolve_codec(None, fed, direction="up"),
                resolve_codec(None, fed, direction="down"), mesh, srv_ps,
                cl_ps, "pod" if mode == "cohort" else "data", n,
                transport_for_mode(tr))
            jobs.append((name, "ex", mesh, jax.jit(ex),
                         (srv, cl, ys, jnp.asarray(inp["exkey"]))))


def compile_job(job):
    name, pre, mesh, fn, args = job
    with mesh:
        return fn.lower(*args).compile()


# XLA compiles in threads of its own: four programs compile side by side
with ThreadPoolExecutor(4) as pool:
    compiled = list(pool.map(compile_job, jobs))
res = {}
for (name, pre, mesh, fn, args), exe in zip(jobs, compiled):
    r = res.setdefault(name, {})
    if pre:
        s2, c2, q = exe(*args)
        r["exqerr"] = np.asarray(q)
    else:
        st2, m = exe(*args)
        s2, c2 = st2.server, st2.clients
        r["qerr"] = np.asarray(m["quant_err_sq"])
        r["h_mean"] = np.asarray(m["h_steps_mean"])
    for k, v in s2.items():
        r[pre + "srv/" + k] = np.asarray(v)
    for k, v in c2.items():
        r[pre + "cl/" + k] = np.asarray(v)
for name, r in res.items():
    np.savez(out + f"/ref_{name}.npz", **r)
print("REFERENCE_OK")
""" % (K, LR, SEQ, B)


class FakeMesh:
    """A mesh's shape and names, for building a step's specs off-rank."""

    def __init__(self, shape, axes):
        self.shape = OrderedDict(zip(axes, shape))
        self.axis_names = tuple(axes)
        self.distributed = True


def _coords(shape, axes):
    return [dict(zip(axes, np.unravel_index(r, shape)))
            for r in range(int(np.prod(shape)))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 8-device outputs and the port's 8 ranks', from the
    same inputs: (cases, inputs, reference outputs, port outputs by
    rank)."""
    from repro.configs import get_reduced as ref_get_reduced
    from repro.launch.steps import init_train_state
    out = tmp_path_factory.mktemp("ranks")
    rcfg = ref_get_reduced(ARCH)
    cases, inputs, ref_cases = {}, {}, {}
    for case in CASES:
        shape, axes, mode, tr, whole, alone = case
        n = shape[0]
        st = init_train_state(rcfg, jax.random.PRNGKey(0), n)
        # every client_dp case from the same inputs (the pins compare them)
        seed = 0 if mode == "client_dp" else 1
        rng = np.random.default_rng(seed)
        inp = {"n": n}
        # the clients start at the server (as the reference's own 8-device
        # test); the exchange alone gets Ys a step off them
        for k, v in st.server.items():
            inp["srv/" + k] = np.asarray(v)
            c = np.asarray(st.clients[k])
            inp["cl/" + k] = c
            inp["ys/" + k] = (c + 0.01 * rng.standard_normal(c.shape)
                              ).astype(np.float32)
        inp["toks"] = rng.integers(0, rcfg.vocab_size, (n, K, B, SEQ),
                                   dtype=np.int32)
        inp["key"] = np.asarray(jax.random.key_data(
            jax.random.PRNGKey(seed)))
        inp["exkey"] = np.asarray(jax.random.key_data(
            jax.random.PRNGKey(100 + seed)))
        np.savez(out / f"in_{case_name(case)}.npz", **inp)
        cases[case_name(case)], inputs[case_name(case)] = case, inp
        # the reference program that serves this case does what any of
        # its cases asks
        rn = reference_name(case)
        was = ref_cases.get(rn, (shape, axes, mode,
                                 REFERENCE_OF.get(tr, tr), False, False))
        ref_cases[rn] = was[:4] + (was[4] or whole, was[5] or alone)
    np.savez(out / "cases.npz", cases=np.array(ref_cases, dtype=object))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    t0 = time.time()
    # the reference compiles while the draws are made here
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(out),
                            str(ROOT / "tests")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ports = _port_ranks(out, cases, inputs)
        t_port = time.time() - t0
        stdout, stderr = ref.communicate(timeout=600)
        print(f"port ranks {t_port:.1f} s, reference {time.time() - t0:.1f} s")
    finally:
        ref.kill()
    assert "REFERENCE_OK" in stdout, stdout + stderr[-4000:]
    refs = {nm: dict(np.load(out / f"ref_{reference_name(c)}.npz"))
            for nm, c in cases.items()}
    return cases, inputs, refs, ports


def _port_ranks(out, cases, inputs):
    """The reference's draws for each rank, the 8 port ranks, and the
    boundary places of their recorded encodes (counted here: one JAX
    compile a shape, not one in each rank)."""
    drawn = {}
    for case in cases.values():
        shape, axes, mode, tr, whole, alone = case
        inp, rn = inputs[case_name(case)], reference_name(case)
        # a transport that draws as its reference program does reuses its
        # draws; the whole-leaf family's are the same on every rank
        step = make_step(case, FakeMesh(shape, axes))
        for r, coords in enumerate(_coords(shape, axes)):
            for pre, on, key, exkey in (("draws", whole, inp["key"], None),
                                        ("exdraws", alone, None,
                                         inp["exkey"])):
                if not on:
                    continue
                at = (pre, rn, r if tr in SHARD_LOCAL else 0)
                if at not in drawn:
                    drawn[at] = reference_step_draws(step, key, coords,
                                                     exchange_key=exkey)
                torch.save(drawn[at], out / f"{pre}_{case_name(case)}_{r}.pt")
    mp.spawn(run_rank, args=(8, str(out)), nprocs=8)
    ports = [torch.load(out / f"port_{r}.pt", weights_only=False)
             for r in range(8)]
    for p in ports:
        for nm, e in p.items():
            srv = [k[4:] for k in inputs[nm] if k.startswith("srv/")]
            if "calls" in e:
                e["stats"] = leaf_stats(LatticeLog(e.pop("calls")), srv,
                                        lattice_candidates)
            if "excalls" in e:
                e["exstats"] = leaf_stats(LatticeLog(e.pop("excalls")), srv,
                                          lattice_flips)
    return ports


def _join(ports, name, part, specs, mesh_shape):
    axes = list(mesh_shape)
    out = {}
    for k in ports[0][name][part]:
        blocks = {tuple(p[name]["coords"][a] for a in axes): p[name][part][k]
                  for p in ports}
        out[k] = npy(join_blocks(blocks, specs[k], mesh_shape))
    return out


def _specs(case):
    return make_step(case, FakeMesh(*case[:2])).specs


def _scale(x):
    return {k: float(np.abs(v).max()) for k, v in x.items()}


@pytest.mark.parametrize("name", [case_name(c) for c in CASES])
def test_ranks_match_reference(runs, name):
    cases, inputs, refs, ports = runs
    case = cases[name]
    n = case[0][0]
    mesh_shape = OrderedDict(zip(case[1], case[0]))
    specs = _specs(case)
    ref = refs[name]
    if case[4]:
        _check_whole_step(ports, name, ref, specs, n, mesh_shape)
    if case[5]:
        _check_exchange(ports, name, ref, specs, n, mesh_shape)


def _check_whole_step(ports, name, ref, specs, n, mesh_shape):
    ref_srv = {k[4:]: v for k, v in ref.items() if k.startswith("srv/")}
    ref_cl = {k[3:]: v for k, v in ref.items() if k.startswith("cl/")}
    srv = _join(ports, name, "server", specs.server, mesh_shape)
    cl = _join(ports, name, "clients", specs.clients, mesh_shape)
    assert all(p[name]["h_mean"] == float(ref["h_mean"]) for p in ports)
    # the places at a rounding boundary bound the codes that may round the
    # other way
    s_srv, s_cl, s_q = flip_slack([p[name]["stats"] for p in ports], n,
                                  _scale(ref_srv), _scale(ref_cl))
    q = ref["qerr"].item()
    assert all(abs(p[name]["qerr"] - q) <= QERR_STEP_TOL * q + s_q
               for p in ports)
    for k in srv:
        for got, want, slack in ((srv[k], ref_srv[k], s_srv[k]),
                                 (cl[k], ref_cl[k], s_cl[k])):
            d = np.linalg.norm(got - want)
            assert d <= SRV_TOL * np.linalg.norm(want) + slack, (k, d, slack)


def _check_exchange(ports, name, ref, specs, n, mesh_shape):
    """The exchange alone on the given Ys: the counted code flips."""
    stats = [p[name]["exstats"] for p in ports]
    flips = sum(c[0] for st in stats for parts in st.values()
                for c in parts.values())
    print(f"{name}: {flips} code flips over the ranks")
    ex_srv = {k[6:]: v for k, v in ref.items() if k.startswith("exsrv/")}
    ex_cl = {k[5:]: v for k, v in ref.items() if k.startswith("excl/")}
    s_srv, s_cl, s_q = flip_slack(stats, n, _scale(ex_srv), _scale(ex_cl))
    exq = ref["exqerr"].item()
    assert all(abs(float(p[name]["exchange"][2]) - exq)
               <= QERR_TOL * exq + s_q for p in ports)
    ex = [{name: dict(p[name], server=p[name]["exchange"][0],
                      clients=p[name]["exchange"][1])} for p in ports]
    xs = _join(ex, name, "server", specs.server, mesh_shape)
    xc = _join(ex, name, "clients", specs.clients, mesh_shape)
    for k in xs:
        for got, want, slack in ((xs[k], ex_srv[k], s_srv[k]),
                                 (xc[k], ex_cl[k], s_cl[k])):
            err = np.abs(got - want) - EX_TOL * (1 + np.abs(want))
            assert err.max() <= slack, (k, err.max(), slack)


def test_port_transports_pin_each_other(runs):
    """The port's own draws, every rank seeded alike: shard_local against
    shard_local_codes (2e-5) and shard_local_rs (0.25 a leaf, 0.02 over the
    model); codes decoded across clients only agree if every data rank
    drew the same signs."""
    cases, _, _, ports = runs
    own = {}
    for tr in SHARD_LOCAL:
        name = "4x2_client_dp_" + tr
        mesh_shape = OrderedDict([("data", 4), ("model", 2)])
        specs = _specs(cases[name])
        own[tr] = _join([{name: dict(p[name], server=p[name]["own"].server)}
                         for p in ports], name, "server", specs.server,
                        mesh_shape)
    num = den = 0.0
    for k, a in own["shard_local"].items():
        np.testing.assert_allclose(own["shard_local_codes"][k], a,
                                   rtol=2e-5, atol=2e-5, err_msg=k)
        c = own["shard_local_rs"][k]
        rel = np.linalg.norm(c - a) / (np.linalg.norm(a) + 1e-9)
        assert rel < 0.25, (k, rel)
        num += float(np.sum((c - a) ** 2))
        den += float(np.sum(a ** 2))
    assert (num / den) ** 0.5 < 0.02


def test_torchrun_two_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--reduced", "--mesh-data", "2", "--steps", "2", "--batch", "2",
         "--seq", "32", "--log-every", "1", "--device", "cpu"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    rows = [ln for ln in r.stdout.splitlines() if ln.startswith("round")]
    assert len(rows) == 2, r.stdout
    # two clients: two uplink messages a round, one downlink
    up = [float(ln.split("bits_up=")[1].split()[0]) for ln in rows]
    down = [float(ln.split("bits_down=")[1].split()[0]) for ln in rows]
    # (the rows print 3 significant digits)
    assert abs(up[1] - 2 * down[1]) <= 0.01 * up[1]
