"""The encoder-decoder and frontend archs (seamless-m4t-medium, an
encoder over stub frame embeddings with a cross-attention in every decoder
layer; llava-next-34b, stub patch embeddings prepended to the text) in the
port against the JAX reference at the reduced configs: the params, the
cache and the specs; ``forward``, its prefill cache (``cross/*`` included)
and four ``decode_step``s; ``lm_loss`` and its gradient; the mesh prefill
and serve steps; one mesh train round with frontend batches.

Weights come from the port's init (``tests/test_torch_zoo.py``'s
``port_lm``), carried across key for key as numpy; frontend embeddings
and tokens come from numpy seeds; the train round's draws are the
reference's, injected (``tests/test_torch_harness.reference_step_draws``).

Tolerances, relative to max |want| unless they say otherwise
(``tests/test_torch_zoo.py``'s): logits, caches and decode steps within
1e-4; the loss within 1e-5 absolute, gradients within 1e-4 of the largest
gradient; the mesh steps' prefill logits within 1e-4 and greedy tokens
equal; the train round (``tests/test_torch_mesh_ranks.py``'s whole step):
H-steps and bits exact, Y within 1e-5, the server and the clients within
‖Δ‖ ≤ 1e-4·‖X‖ per leaf plus what the codes at a rounding boundary can
move (``test_torch_harness.flip_slack`` of ``lattice_candidates``),
quant_err within 1e-4 relative plus 4γ²/n a boundary uplink code.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import (LatticeLog, flip_slack, gauss,
                                lattice_candidates, leaf_stats, npy,
                                reference_step_draws, tt)
from test_torch_lm import tokens
from test_torch_zoo import (GRAD_TOL, LOGIT_TOL, LOSS_TOL, _close,
                            one_thread, port_lm)  # noqa: F401
import repro.launch.steps as ref_steps
from repro import configs as ref_configs
from repro.configs.base import FedConfig as RefFedConfig
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.core.transport import tree_bits as ref_tree_bits
from repro.launch import specs as ref_specs
from repro.models import model as ref_model
from repro.utils.compat import make_mesh as ref_make_mesh
from repro_torch import configs
from repro_torch.configs.base import FedConfig, ShapeConfig
from repro_torch.core.transport import tree_bits
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step, rank_blocks)
from repro_torch.models import model
from repro_torch.utils import interop

SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
ARCHS = [SEAMLESS, LLAVA]
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
B, T, F_ENC = 2, 24, 12


def _frontend(cfg, seed, b, f):
    """Stub frontend embeddings (b, f, d), unit normal from a numpy
    seed."""
    return gauss(seed, (b, f, cfg.d_model))


def _f(cfg):
    """The frontend length: the encoder's frames, or the vision tokens."""
    return F_ENC if cfg.encdec else cfg.n_frontend_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_cache_match_reference(arch):
    """``build_params``' keys, shapes, dtypes and axes (the encoder stack
    under ``enc/``, the cross blocks) and ``init_cache`` (with
    ``enc_len``) against the reference's."""
    rcfg, cfg = ref_configs.get_reduced(arch), configs.get_reduced(arch)
    ref_p, ref_axes = ref_model.abstract_lm(rcfg)
    p, axes = model.init_lm(cfg, seed=0, device="cpu")
    assert sorted(p) == sorted(ref_p)
    assert axes == {k: tuple(v) for k, v in ref_axes.items()}
    for k, v in ref_p.items():
        assert tuple(p[k].shape) == tuple(v.shape), k
        assert str(p[k].dtype) == f"torch.{v.dtype}", k
    # the reference's flat params carry across key for key, the encoder
    # stack and the cross blocks included
    back = interop.lm_params_from_numpy({k: npy(v) for k, v in p.items()},
                                        "cpu")
    assert all(torch.equal(back[k], v) for k, v in p.items())
    enc = sorted(k for k in p if k.startswith("enc/"))
    cross = sorted(k for k in p if "cross" in k)
    if cfg.encdec:
        assert len(p) == 27 and len(enc) == 10 and len(cross) == 5
        assert p["enc/body/0/attn/wq"].shape[0] == cfg.n_enc_layers
    else:
        assert enc == cross == []
    rc = ref_model.init_cache(rcfg, B, 40, abstract=True, enc_len=F_ENC)
    c = model.init_cache(cfg, B, 40, device="cpu", enc_len=F_ENC)
    assert sorted(c) == sorted(rc)
    for k, v in rc.items():
        assert tuple(c[k].shape) == tuple(v.shape), k
        assert str(c[k].dtype) == f"torch.{v.dtype}", k
    assert ("body/0/cross/k" in c) == cfg.encdec


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_reference(arch):
    """``forward``'s logits over the text positions and its prefill cache
    (``cross/{k,v}`` at F included), then four decode steps and the caches
    after them; decoding starts after the frontend's positions."""
    rcfg, cfg, rp, p = port_lm(arch)
    f = _f(cfg)
    toks = tokens(1, B, T, cfg.vocab_size)
    fe = _frontend(cfg, 3, B, f)
    nxt = tokens(2, B, 4, cfg.vocab_size)
    start = T if cfg.encdec else f + T
    depth = start + 8
    rcache = ref_model.init_cache(rcfg, B, depth, enc_len=f)
    want, rcache, _ = jax.jit(partial(ref_model.forward, rcfg))(
        rp, {"tokens": toks, "frontend": fe}, cache=rcache)
    assert want.shape == (B, T, cfg.vocab_size)
    cache = model.init_cache(cfg, B, depth, device="cpu", enc_len=f)
    got, cache, _ = model.forward(
        cfg, p, {"tokens": tt(toks).long(), "frontend": tt(fe)}, cache=cache)
    _close(got, want, LOGIT_TOL, "forward")
    assert sorted(cache) == sorted(rcache)
    for k in rcache:
        _close(cache[k], rcache[k], LOGIT_TOL, k)
    ref_step = jax.jit(partial(ref_model.decode_step, rcfg))
    for i in range(nxt.shape[1]):
        rl, rcache = ref_step(rp, nxt[:, i:i + 1], np.int32(start + i),
                              rcache)
        lg, cache = model.decode_step(cfg, p, tt(nxt[:, i:i + 1]).long(),
                                      start + i, cache)
        _close(lg, rl, LOGIT_TOL, f"step {i}")
    for k in rcache:
        _close(cache[k], rcache[k], LOGIT_TOL, k)
    if cfg.encdec:
        # the cross K/V are written in place: a cache of another length
        # is refused, naming the length to make it with
        short = model.init_cache(cfg, B, depth, device="cpu", enc_len=f - 1)
        with pytest.raises(ValueError, match=f"enc_len={f}"):
            model.forward(cfg, p, {"tokens": tt(toks).long(),
                                   "frontend": tt(fe)}, cache=short)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradient_matches_reference(arch):
    """``lm_loss`` over the text positions and its gradient through the
    encoder, the cross blocks and the decoder (or the fused sequence)."""
    rcfg, cfg, rp, pp = port_lm(arch)
    toks = tokens(5, B, T, cfg.vocab_size)
    fe = _frontend(cfg, 6, B, _f(cfg))
    batch = {"tokens": toks, "frontend": fe}
    (want_loss, wm), want = jax.jit(jax.value_and_grad(
        lambda q: ref_model.lm_loss(rcfg, q, batch), has_aux=True))(
        {k: jnp.asarray(v) for k, v in rp.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    loss, m = model.lm_loss(cfg, leaves, {"tokens": tt(toks).long(),
                                          "frontend": tt(fe)})
    grads = torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])
    for got_v, want_v in ((loss, want_loss), (m["ce"], wm["ce"])):
        assert abs(float(got_v.detach()) - float(want_v)) <= LOSS_TOL
    scale = max(float(np.abs(np.asarray(want[k])).max()) for k in want)
    for k, g in zip(sorted(leaves), grads):
        err = np.abs(npy(g) - np.asarray(want[k])).max()
        assert err <= GRAD_TOL * scale, (arch, k, err, scale)
    # an encoder-decoder model's gradient reaches its encoder and its
    # cross blocks
    assert not cfg.encdec or all(
        float(g.abs().max()) > 0 for k, g in zip(sorted(leaves), grads)
        if k.startswith(("enc/body/0/attn", "body/0/cross/w")))


SEQ, STEPS, T_MESH = 64, 4, 12


def _reference_mesh(rcfg, rp, batch, start):
    """The reference's prefill step and STEPS serve steps, jitted on a
    one-device mesh: (last logits, tokens (b, STEPS + 1), the prefill's
    cache)."""
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    with mesh:
        pre, _, (p_sh, b_sh) = ref_steps.build_prefill_step(
            rcfg, mesh, RefShapeConfig("p", SEQ, B, "prefill"))
        srv, _, _, shs = ref_steps.build_serve_step(
            rcfg, mesh, RefShapeConfig("d", SEQ, B, "decode"))
        params = {k: jnp.asarray(v) for k, v in rp.items()}
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, cache0 = jax.jit(pre, in_shardings=(p_sh, b_sh)).lower(
            params, batch).compile(compiler_options=CHEAP)(params, batch)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        srv_c = jax.jit(srv, in_shardings=shs).lower(
            params, cache0, tok, jnp.int32(start)).compile(
                compiler_options=CHEAP)
        out, cache = [np.asarray(tok)], cache0
        for i in range(STEPS):
            tok, cache = srv_c(params, cache, tok, jnp.int32(start + i))
            out.append(np.asarray(tok))
    return (np.asarray(logits), np.concatenate(out, 1),
            {k: np.asarray(v) for k, v in cache0.items()})


@pytest.mark.parametrize("arch,frames", [
    (SEAMLESS, "input_specs"), (SEAMLESS, "enc_len_for"),
    (LLAVA, "input_specs")])
def test_mesh_prefill_and_serve_match_reference(arch, frames):
    """``build_prefill_step`` then ``build_serve_step`` on the (1, 1)
    mesh against the reference's: the prefill's cache, its cross K/V at
    the frontend's F (seq_len//2 frames as ``input_specs`` gives them, or
    ``enc_len_for``, the length the serve step's cache specs name), the
    last logits, then greedy tokens."""
    rcfg, cfg, rp, pp = port_lm(arch)
    shape = ShapeConfig("p", SEQ, B, "prefill")
    f = (specs.enc_len_for(shape) if frames == "enc_len_for"
         else int(specs.input_specs(cfg, shape)["frontend"].shape[1]))
    if cfg.encdec:
        assert f == (16 if frames == "enc_len_for" else SEQ // 2)
    toks = tokens(7, B, T_MESH, cfg.vocab_size)
    fe = _frontend(cfg, 8, B, f)
    start = T_MESH if cfg.encdec else f + T_MESH
    want_logits, want_toks, want_cache = _reference_mesh(
        rcfg, rp, {"tokens": toks, "frontend": fe}, start)

    mesh = make_mesh((1, 1), ("data", "model"))
    prefill, _, (p_specs, b_specs) = build_prefill_step(cfg, mesh, shape)
    step, _, cache_spec, (_, c_specs, _, _) = build_serve_step(
        cfg, mesh, ShapeConfig("d", SEQ, B, "decode"))
    assert sorted(b_specs) == ["frontend", "tokens"]
    params = rank_blocks(pp, p_specs, mesh)
    logits, cache = prefill(params, {"tokens": tt(toks),
                                     "frontend": tt(fe)})
    assert cache.keys() == cache_spec.keys() == c_specs.keys()
    for k, v in want_cache.items():
        assert tuple(cache[k].shape) == v.shape, k
        _close(cache[k], v, LOGIT_TOL, k)
    if cfg.encdec:
        assert cache["body/0/cross/k"].shape[2] == f
        assert (tuple(cache["body/0/cross/k"].shape)
                == tuple(cache_spec["body/0/cross/k"].shape)) == (
                    frames == "enc_len_for")
    _close(logits, want_logits, LOGIT_TOL, "prefill")
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(STEPS):
        tok, cache = step(params, cache, tok, start + i)
        out.append(tok)
    np.testing.assert_array_equal(npy(torch.cat(out, 1)), want_toks)


def _serve_engine(cfg):
    from repro_torch.serving import ServeEngine
    ServeEngine(cfg, {"embed/tok": torch.zeros((cfg.vocab_size,
                                                cfg.d_model))})


def _serve_cli(cfg):
    from repro_torch.launch import serve
    serve.main(["--arch", cfg.name, "--device", "cpu"])


def _serve_requests(cfg):
    from repro_torch.examples import serve_requests
    serve_requests.main(["--arch", cfg.name, "--device", "cpu"])


def _run_registry(cfg):
    from repro_torch.launch import train
    args = train.parse_args(["--arch", cfg.name, "--reduced", "--device",
                             "cpu", "--algo", "quafl"])
    train.run_registry(args, cfg, train.fed_config(args), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path", [_serve_engine, _serve_cli, _serve_requests,
                                  _run_registry],
                         ids=["ServeEngine", "launch_serve", "serve_requests",
                              "run_registry"])
def test_token_paths_refuse_frontend_archs(path, arch):
    """The paths that carry token batches only refuse an encoder-decoder
    or frontend arch, saying why (the reference's token path has no
    frontend batches; its engine would fail on a missing key), where the
    reference crashes or refuses without a reason: ``ServeEngine``,
    ``launch/serve.py``, ``examples/serve_requests.py`` and
    ``launch/train.run_registry``."""
    cfg = configs.get_reduced(arch)
    with pytest.raises((NotImplementedError, SystemExit),
                       match="carries no frontend batches"):
        path(cfg)


K, B_TRAIN, SEQ_TRAIN, LR = 2, 2, 48, 0.05
Y_TOL, SRV_TOL, QERR_TOL = 1e-5, 1e-4, 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_frontend_matches_reference(arch, monkeypatch):
    """One ``build_train_step`` round (QuAFL b = 8, ``dequant_psum``) with
    frontend batches (n_slots, K, b, F, d) on the (1, 1) mesh, llava in
    its cohort mode, against the reference's jitted step from the same
    state and batch with its draws: H-steps and bits exact, Y within
    1e-5, the server and the clients within the mesh tests' tolerances
    (codes at a rounding boundary counted)."""
    rcfg, cfg, rp, _ = port_lm(arch)
    fed = dict(local_steps=K, lr=LR, bits=8, transport="dequant_psum")
    rshape = RefShapeConfig("t", SEQ_TRAIN, B_TRAIN, "train")
    shape = ShapeConfig("t", SEQ_TRAIN, B_TRAIN, "train")
    in_specs = ref_specs.input_specs(rcfg, rshape, n_slots=1, local_steps=K)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, in_specs["tokens"].shape).astype(np.int32)
    fe = gauss(10, in_specs["frontend"].shape)
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    rec = {}
    orig = ref_steps.leaf_dist

    def leaf_dist(a, b):
        jax.debug.callback(lambda y: rec.update(
            Y={k: np.asarray(v) for k, v in y.items()}), a)
        return orig(a, b)

    monkeypatch.setattr(ref_steps, "leaf_dist", leaf_dist)
    # the reference's initial state (the clients at the server) of the
    # port's weights
    st = ref_steps.TrainState(
        server={k: jnp.asarray(v) for k, v in rp.items()},
        clients={k: jnp.asarray(v)[None] for k, v in rp.items()},
        t=jnp.zeros((), jnp.int32))
    key = jax.random.key_data(jax.random.PRNGKey(2))
    args = (st, {"tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)},
            key)
    with mesh:
        fn = ref_steps.build_train_step(rcfg, RefFedConfig(**fed), mesh,
                                        rshape, remat=False)[0]
        st2, m = jax.jit(fn).lower(*args).compile(
            compiler_options=CHEAP)(*args)
        jax.block_until_ready(st2)
        jax.effects_barrier()

    port_mesh = make_mesh((1, 1), ("data", "model"))
    step, _, (specs_, b_specs) = build_train_step(
        cfg, FedConfig(**fed), port_mesh, shape, device="cpu")
    assert step.fed_mode == ("cohort" if arch == LLAVA else "client_dp")
    assert sorted(b_specs) == ["frontend", "tokens"]
    assert tree_bits(step.quant_up, step.state_spec.server) == ref_tree_bits(
        ref_steps.resolve_codec(None, RefFedConfig(**fed), direction="up"),
        st.server)
    draws = reference_step_draws(step, key, {"data": 0, "model": 0})
    def state():
        return interop.train_state_from_numpy(
            {k: np.asarray(v) for k, v in st.server.items()},
            {k: np.asarray(v) for k, v in st.clients.items()}, st.t,
            port_mesh, specs_, "cpu")
    ys = {}
    exchange = step.exchange

    def spy(st_, Ys, draws=None):
        ys.update({k: v.clone() for k, v in Ys.items()})
        return exchange(st_, Ys, draws)
    step.exchange = spy
    log = LatticeLog()
    restore = log.install()
    try:
        out, pm = step(state(), {"tokens": tt(toks).long(),
                                 "frontend": tt(fe)}, None, draws)
    finally:
        restore()
    assert float(pm["h_steps_mean"]) == float(m["h_steps_mean"]) > 0
    for k in st.server:
        y = rec["Y"][k]
        assert np.abs(npy(ys[k]) - y).max() <= Y_TOL * np.abs(y).max(), k
    if cfg.encdec:
        # the local steps reached the encoder and the cross blocks
        assert all(not np.array_equal(rec["Y"][k], np.asarray(st.server[k]))
                   for k in st.server
                   if k.startswith(("enc/body/0/attn", "body/0/cross/w")))
    # the places at a rounding boundary bound the codes that may round the
    # other way (the hints' last bits move the downlink's γ too)
    stats = leaf_stats(log, st.server, lattice_candidates)
    s_srv, s_cl, s_q = flip_slack(
        [stats], 1,
        {k: np.abs(np.asarray(v)).max() for k, v in st2.server.items()},
        {k: np.abs(np.asarray(v)).max() for k, v in st2.clients.items()})
    q_ref = float(m["quant_err_sq"])
    assert abs(float(pm["quant_err_sq"]) - q_ref) <= QERR_TOL * q_ref + s_q
    for k in st.server:
        for got, want, slack in ((out.server[k], st2.server[k], s_srv[k]),
                                 (out.clients[k], st2.clients[k], s_cl[k])):
            want = np.asarray(want)
            d = np.linalg.norm(npy(got) - want)
            assert d <= SRV_TOL * np.linalg.norm(want) + slack, (k, d, slack)
