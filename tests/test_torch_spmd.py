"""The mesh train step in the port (``repro_torch.launch.steps``,
``repro_torch.core.exchange_local``, ``repro_torch.launch.spmd``) against
the JAX reference on the (1, 1) mesh, in-process, at reduced llama3.2-1b.

The reference's step runs jitted from one state (the clients at the
server, as the reference's own tests start) and one token batch; its Y is read out of ``slot_progress`` with a
debug callback, and its draws (H-steps, signs, rounding noise, message
keys) are injected into the port through ``tests/test_torch_harness.py``.

Tolerances:
* a whole step (the local SGD's reductions run in another order; the
  reference's step of the transport's family, the same arithmetic at
  (1, 1)): Y within
  1e-5·max|Y| per leaf, the server within ‖Δ‖/‖X_{t+1}‖ ≤ 1e-4 per leaf;
* the exchange alone, on the reference's Y with its draws: every code of
  every encode equal to the reference's encode of the same inputs (the
  port's γ), except ±1 mod L where y/γ+u sits within 1e-3 of an integer
  (each such flip counted and reported); servers and clients within rtol
  = atol = 2e-5, plus what the counted flips of the leaf can move
  (``test_torch_harness.flip_slack``: γ/(n+1) each, and the downlink γ's
  rescaling by the uplink's shifted hint); ``quant_err_sq`` within 1e-5
  relative plus 4γ²/n a flipped uplink code;
* quantization-free with lr 0: the model mean kept within 1e-5;
* the engine, the meshes of one and the CLIs: bit for bit, bits exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import (LatticeLog, flip_slack, lattice_flips,
                                leaf_stats, npy, reference_step_draws, tt)
import repro.launch.steps as ref_steps
from repro.configs import get_reduced as ref_get_reduced
from repro.configs.base import FedConfig as RefFedConfig
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.launch.spmd import SpmdAlgorithm as RefSpmd
from repro.utils.compat import make_mesh as ref_make_mesh
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedConfig, ShapeConfig
from repro_torch.core.transport import tree_bits
from repro_torch.data.synthetic import federated_token_task
from repro_torch.examples import train_e2e
from repro_torch.fed import make_algorithm, simulate
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.steps import (TRANSPORTS, TrainState,
                                      build_train_step)
from repro_torch.models.model import init_lm
from repro_torch.utils import interop

ARCH = "llama3.2-1b"
K, B, SEQ, LR = 2, 2, 16, 0.05
Y_TOL, SRV_TOL, EX_TOL, QERR_TOL = 1e-5, 1e-4, 2e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced widths gain nothing from intra-op threads, and the suite's
    workers share the machine's cores: one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fed(cls, transport, **kw):
    return cls(**{**dict(local_steps=K, lr=LR, bits=8, transport=transport),
                  **kw})


def _full(x):
    return {k: np.asarray(v) for k, v in x.items()}


_REF = {}


# at (1, 1) the reference's transports of one family run the same
# arithmetic on one client (a code all-gather of one message, a psum over
# one rank, no shardable reduce-scatter), so one step a family serves each
FAMILY = {"dequant_psum": "dequant_psum", "code_allgather": "dequant_psum",
          "shard_local": "shard_local", "shard_local_codes": "shard_local",
          "shard_local_rs": "shard_local"}


def reference_step(transport):
    """The reference's jitted step on the (1, 1) mesh: (state in, state out,
    metrics, Y of slot 0, tokens, key), one a family, made on first use."""
    if not _REF:
        _reference_steps()
    return _REF[FAMILY[transport]]


def _reference_steps():
    from concurrent.futures import ThreadPoolExecutor
    rcfg = ref_get_reduced(ARCH)
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    rec = {}
    orig = ref_steps.leaf_dist

    def leaf_dist(a, b):
        jax.debug.callback(lambda y: rec.update(Y=_full(y)), a)
        return orig(a, b)

    st = ref_steps.init_train_state(rcfg, jax.random.PRNGKey(0), 1)
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, K, B, SEQ), 0,
                              rcfg.vocab_size)
    key = jax.random.key_data(jax.random.PRNGKey(2))
    args = (st, {"tokens": toks}, key)
    ref_steps.leaf_dist = leaf_dist
    try:
        with mesh:
            fns = {tr: jax.jit(ref_steps.build_train_step(
                rcfg, _fed(RefFedConfig, tr), mesh,
                RefShapeConfig("t", SEQ, B, "train"), fed_mode="client_dp",
                transport=tr, remat=False)[0])
                for tr in set(FAMILY.values())}

            def compile_one(tr):
                with mesh:
                    return fns[tr].lower(*args).compile()
            with ThreadPoolExecutor(len(fns)) as pool:
                exes = dict(zip(fns, pool.map(compile_one, fns)))
            for tr, exe in exes.items():
                st2, m = exe(*args)
                jax.block_until_ready(st2)
                jax.effects_barrier()
                _REF[tr] = (st, st2, m, rec["Y"], np.asarray(toks), key)
    finally:
        ref_steps.leaf_dist = orig


def port_step(transport, **kw):
    mesh = make_mesh((1, 1), ("data", "model"))
    step, _, _ = build_train_step(
        get_reduced(ARCH), _fed(FedConfig, transport), mesh,
        ShapeConfig("t", SEQ, B, "train"), fed_mode="client_dp",
        transport=transport, device="cpu", **kw)
    return step


def port_state(st, step=None):
    """The reference's state on the port's (1, 1) rank, through
    ``interop.train_state_from_numpy``."""
    step = step or port_step("dequant_psum")
    return interop.train_state_from_numpy(
        _full(st.server), _full(st.clients), st.t, step.mesh, step.specs,
        "cpu")


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_step_matches_reference(transport, monkeypatch, record_property):
    st, st2, m, Y, toks, key = reference_step(transport)
    step = port_step(transport)
    draws = reference_step_draws(step, key, {"data": 0, "model": 0})
    ys = {}
    exchange = step.exchange

    def spy(state, Ys, draws=None):
        ys.update({k: v.clone() for k, v in Ys.items()})
        return exchange(state, Ys, draws)
    step.exchange = spy
    out, pm = step(port_state(st), {"tokens": tt(toks).long()}, None, draws)
    assert float(pm["h_steps_mean"]) == float(m["h_steps_mean"])
    for k in st.server:
        y = Y[k]
        assert np.abs(npy(ys[k]) - y).max() <= Y_TOL * np.abs(y).max(), k
        x = np.asarray(st2.server[k])
        d = np.linalg.norm(npy(out.server[k]) - x)
        assert d <= SRV_TOL * np.linalg.norm(x), (k, d / np.linalg.norm(x))

    # the exchange alone, on the reference's Y
    log = LatticeLog()
    restore = log.install()
    try:
        step = port_step(transport)
        srv, cl, qerr = step.exchange(
            port_state(st), {k: tt(v) for k, v in Y.items()}, draws)
    finally:
        restore()
    stats = leaf_stats(log, st.server, lattice_flips)
    flips = sum(p[0] for parts in stats.values() for p in parts.values())
    record_property("code_flips", flips)
    print(f"{transport}: {flips} code flips in {len(log.calls)} calls")
    s_srv, s_cl, s_q = flip_slack(
        [stats], 1, {k: np.abs(v).max() for k, v in _full(st2.server).items()},
        {k: np.abs(v).max() for k, v in _full(st2.clients).items()})
    q_ref = float(m["quant_err_sq"])
    assert abs(float(qerr) - q_ref) <= QERR_TOL * q_ref + s_q
    for k in st.server:
        for got, want, slack in ((srv[k], st2.server[k], s_srv[k]),
                                 (cl[k], st2.clients[k], s_cl[k])):
            want = np.asarray(want)
            err = np.abs(npy(got) - want) - EX_TOL * (1 + np.abs(want))
            assert err.max() <= slack, (k, err.max(), slack)


def test_mean_preserved_without_quantization():
    """lr 0, no quantization: server + client mean kept by the step (the
    reference's ``test_train_step_mean_preservation_quantfree``)."""
    cfg = get_reduced("olmo-1b")
    mesh = make_mesh((1, 1), ("data", "model"))
    fed = FedConfig(local_steps=1, lr=0.0, quantizer="none")
    step, _, _ = build_train_step(cfg, fed, mesh, ShapeConfig("t", 16, 4,
                                                              "train"),
                                  fed_mode="client_dp", quantized=False,
                                  device="cpu")
    p, _ = init_lm(cfg, seed=0, device="cpu")
    g = torch.Generator()
    g.manual_seed(3)
    st = TrainState(server=p, clients={
        k: (v + 0.1 * torch.randn(v.shape, generator=g))[None]
        for k, v in p.items()}, t=torch.zeros((), dtype=torch.int64))
    st2, _ = step(st, {"tokens": torch.zeros((1, 1, 4, 16),
                                             dtype=torch.int64)}, g)
    for k in st.server:
        mu0 = (st.server[k] + st.clients[k].sum(0)) / 2
        mu1 = (st2.server[k] + st2.clients[k].sum(0)) / 2
        torch.testing.assert_close(mu1, mu0, rtol=0, atol=1e-5)


def _spmd(transport="dequant_psum", mesh=None, **fed_kw):
    cfg = get_reduced(ARCH)
    p0, _ = init_lm(cfg, seed=0, device="cpu")
    fed = _fed(FedConfig, transport, n_clients=1, s=1, **fed_kw)
    alg = make_algorithm("spmd", fed, loss_fn=None, template=p0, cfg=cfg,
                         mesh=mesh, batch=B, seq=SEQ, device="cpu")
    data, _ = federated_token_task(0, 1, 16, B, SEQ, cfg.vocab_size,
                                   device="cpu")
    return alg, p0, data


@pytest.mark.parametrize("transport", ["dequant_psum", "shard_local_rs"])
def test_spmd_chunks_equal_eager(transport):
    traces = {}
    for chunk in (0, 2):
        alg, p0, data = _spmd(transport)
        g = torch.Generator()
        g.manual_seed(4)
        traces[chunk] = simulate(alg, p0, data, g, rounds=4, eval_every=0,
                                 record_every=1, scan_chunk=chunk)
    assert traces[2].engine == "scanned"
    for key in ("bits_up", "bits_down", "sim_time", "quant_err",
                "h_steps_mean"):
        assert traces[0].column(key) == traces[2].column(key), key
    a, b = traces[0].final_state.train, traces[2].final_state.train
    for k in a.server:
        assert torch.equal(a.server[k], b.server[k])
        assert torch.equal(a.clients[k], b.clients[k])


def test_spmd_round_matches_reference_round():
    """One ``SpmdAlgorithm.round``: the token rows from ``split(key)[0]``,
    then the step's draws from ``split(key)[1]``; bits and sim_time exact,
    the server within 1e-4 per leaf, quant_err within 1e-4 relative."""
    alg, p0, data = _spmd()
    rcfg = ref_get_reduced(ARCH)
    rp = {k: jnp.asarray(npy(v)) for k, v in p0.items()}
    ref = RefSpmd(fed=_fed(RefFedConfig, "dequant_psum", n_clients=1, s=1),
                  template=rp, cfg=rcfg, batch=B, seq=SEQ)
    rdata = {"tokens": jnp.asarray(npy(data["tokens"]))}
    key = jax.random.PRNGKey(5)
    rst, rm = ref.round(ref.init(rp), rdata, key)
    k_b, k_r = jax.random.split(key)
    draws = reference_step_draws(alg._step, jax.random.key_data(k_r),
                                 {"data": 0, "model": 0})
    draws["rows"] = tt(npy(jax.random.randint(
        k_b, (1, K, B), 0, data["tokens"].shape[1])))
    st, m = alg.round(alg.init(p0), data, None, draws)
    assert m["bits_up"] == float(rm["bits_up"]) == alg._bits_up_msg
    assert m["bits_down"] == float(rm["bits_down"])
    assert float(m["sim_time"]) == float(rm["sim_time"])
    assert abs(float(m["quant_err"]) - float(rm["quant_err"])) <= \
        1e-4 * float(rm["quant_err"])
    for k in rp:
        x = np.asarray(rst.train.server[k])
        d = np.linalg.norm(npy(st.train.server[k]) - x)
        assert d <= SRV_TOL * np.linalg.norm(x), k


def test_spmd_needs_cfg():
    cfg = get_reduced(ARCH)
    p0, _ = init_lm(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="cfg"):
        make_algorithm("spmd", FedConfig(), loss_fn=None, template=p0,
                       device="cpu")
    with pytest.raises(ValueError, match="cfg"):
        RefSpmd(fed=RefFedConfig(), template={})


@pytest.mark.parametrize("codec", ["lattice", "scalar:bits=6", "identity"])
def test_spmd_bits_by_codec(codec):
    alg, p0, data = _spmd(codec_up=codec, codec_down=codec)
    rcfg = ref_get_reduced(ARCH)
    rp = {k: jnp.asarray(npy(v)) for k, v in p0.items()}
    ref = RefSpmd(fed=_fed(RefFedConfig, "dequant_psum", n_clients=1, s=1,
                           codec_up=codec, codec_down=codec),
                  template=rp, cfg=rcfg, batch=B, seq=SEQ)
    assert alg._bits_up_msg == ref._bits_up_msg == tree_bits(alg.codec_up,
                                                             p0)
    assert alg._bits_down_msg == ref._bits_down_msg
    g = torch.Generator()
    g.manual_seed(0)
    st, m = alg.round(alg.init(p0), data, g)
    assert m["bits_up"] == alg._bits_up_msg
    assert m["bits_down"] == alg._bits_down_msg
    assert np.isfinite(float(m["quant_err"]))


def test_group_of_one_equals_local_mesh():
    """A gloo process group of one rank runs every collective and changes
    nothing: the local (1, 1) mesh and the group's, bit for bit."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for transport in TRANSPORTS:
            out = []
            for mesh in (Mesh((1, 1), ("data", "model")),
                         make_mesh((1, 1), ("data", "model"))):
                alg, p0, data = _spmd(transport, mesh=mesh)
                g = torch.Generator()
                g.manual_seed(1)
                st, ms = alg.init(p0), []
                for _ in range(2):
                    st, m = alg.round(st, data, g)
                    ms.append({k: float(v) for k, v in m.items()})
                out.append((st.train, ms))
            assert out[1][0] is not None and out[0][1] == out[1][1]
            for k in out[0][0].server:
                assert torch.equal(out[0][0].server[k], out[1][0].server[k])
                assert torch.equal(out[0][0].clients[k],
                                   out[1][0].clients[k])
    finally:
        dist.destroy_process_group()


CLI = ["--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
       "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_train_cli_spmd_runs(transport, capsys):
    """``launch/train.py`` with its defaults (``--algo spmd --transport
    dequant_psum``) and every other transport at reduced width."""
    argv = CLI if transport == "dequant_psum" else CLI + ["--transport",
                                                          transport]
    run = train.main(argv)
    out = capsys.readouterr().out
    assert run.alg.fed.transport == transport
    bits = tree_bits(run.alg.codec_up, run.alg.template)
    for r in run.trace.rows:
        assert r["bits_up"] == r["bits_down"] == bits
        assert np.isfinite(r["server_loss"])
    assert "round     2 server_loss=" in out and "engine=eager" in out


def test_train_e2e_twin_runs(capsys):
    state = train_e2e.main(["--tiny", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "params=0.4M" in out and "round    2/2 server_loss=" in out
    assert all(torch.isfinite(v).all() for v in state.server.values())

