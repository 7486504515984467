"""The port's dense LM (layers, attention branches, ``forward``,
``decode_step``, ``lm_loss``) against the JAX reference at reduced widths.

The reference's weights come across key for key with
``lm_params_from_numpy``; tokens come from numpy seeds. On the CPU the
port's prefill kernel branch (t % 128 == 0) runs ``flash_attention_plain``;
the reference runs its jnp path, or its Pallas kernel in interpret mode
when ``USE_FLASH_KERNEL`` is set (set inside the test and restored, as
``tests/test_flash_integration.py`` does). Reduced configs are fp32
throughout, so the tolerances are fp32 ones: layers 1e-6, logits and
caches 1e-4 absolute (|logit| up to ~10 after two layers).
"""
import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from test_torch_harness import gauss, npy, tt
from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.configs.base import (ATTN_CHUNKED, ATTN_FULL, ATTN_SLIDING,
                                      LayerSpec)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention, layers, model, moe
from repro_torch.models.params import has_subtree, subtree
from repro_torch.utils.interop import cache_from_numpy, lm_params_from_numpy

ARCHS = ["llama3.2-1b", "gemma2-2b", "olmo-1b"]
FRONTEND_ARCHS = ["seamless-m4t-medium", "llava-next-34b"]
LAYER_TOL, LOGIT_TOL = 1e-6, 1e-4


def reference_lm(arch, seed=0, embed_scale=1.0):
    """(reference cfg, port cfg, reference params as numpy, port params)."""
    rcfg = ref_configs.get_reduced(arch)
    cfg = configs.get_reduced(arch)
    params, _ = ref_model.init_lm(rcfg, jax.random.PRNGKey(seed))
    params = {k: np.asarray(v) for k, v in params.items()}
    params["embed/tok"] = params["embed/tok"] * np.float32(embed_scale)
    return rcfg, cfg, params, lm_params_from_numpy(params, "cpu")


def tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS + FRONTEND_ARCHS)
def test_config_numbers_match_reference(arch):
    for get in ("get_config", "get_reduced"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(configs, get)(arch)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "rope_theta", "logit_softcap",
                  "attn_softcap", "nonparametric_ln", "tie_embeddings",
                  "encdec", "n_enc_layers", "frontend", "n_frontend_tokens",
                  "dtype", "param_dtype", "n_periods", "name", "arch_type",
                  "source"):
            assert getattr(port, f) == getattr(ref, f), (arch, get, f)
        assert ([(s.attn, s.window) for s in port.schedule]
                == [(s.attn, s.window) for s in ref.schedule])


def test_registry_refuses_unported_archs():
    """The registry holds the reference's whole LM zoo: the
    encoder-decoder and frontend archs (ROADMAP Queue 1 item 12) now run,
    as does a frontend config of another arch; an unknown arch refuses;
    and the shard_map MoE (item 14) runs: on the local mesh it equals
    'ragged' bit for bit, and without a mesh it asks for one."""
    assert set(ARCHS + FRONTEND_ARCHS) < set(configs.list_archs())
    assert sorted(configs.list_archs()) == sorted(
        a for a in ref_configs.list_archs() if a != "paper-mlp")
    for arch in FRONTEND_ARCHS:
        assert configs.get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")
    vlm = configs.get_reduced("llama3.2-1b").replace(frontend="vision",
                                                     n_frontend_tokens=4)
    p, _ = model.init_lm(vlm, device="cpu")
    fe = torch.zeros((1, 4, vlm.d_model))
    logits, _, _ = model.forward(vlm, p, {"tokens": torch.zeros(
        (1, 8), dtype=torch.int64), "frontend": fe})
    assert logits.shape == (1, 8, vlm.vocab_size)
    cfg = configs.get_reduced("deepseek-v2-236b")
    shmap = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                impl="ragged_shmap"))
    p, _ = model.init_lm(shmap, device="cpu")
    toks = {"tokens": torch.arange(8, dtype=torch.int64)[None] * 37
            % cfg.vocab_size}
    moe.set_moe_mesh(None)
    with pytest.raises(ValueError, match="set_moe_mesh"):
        model.forward(shmap, p, toks)
    moe.set_moe_mesh(Mesh((1, 1), ("data", "model")))
    try:
        got = model.forward(shmap, p, toks)[0]
    finally:
        moe.set_moe_mesh(None)
    assert torch.equal(got, model.forward(cfg, p, toks)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_keys_shapes_dtypes_match_reference(arch):
    rcfg, cfg = ref_configs.get_reduced(arch), configs.get_reduced(arch)
    ref_p, ref_axes = ref_model.init_lm(rcfg, jax.random.PRNGKey(0))
    p, axes = model.init_lm(cfg, seed=0, device="cpu")
    assert sorted(p) == sorted(ref_p)
    assert axes == {k: tuple(v) for k, v in ref_axes.items()}
    for k, v in ref_p.items():
        assert tuple(p[k].shape) == tuple(v.shape), k
        assert str(p[k].dtype) == f"torch.{v.dtype}", k
    assert has_subtree(p, "body/0/attn") and not has_subtree(p, "body/0/moe")
    assert sorted(subtree(p, "body/0/mlp")) == ["w_down", "w_gate", "w_up"]
    again, _ = model.init_lm(cfg, seed=0, device="cpu")
    other, _ = model.init_lm(cfg, seed=1, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["embed/tok"], other["embed/tok"])
    # the reference's init scale: N(0, 1/fan_in), embeddings 1/sqrt(d)
    w = p["body/0/mlp/w_down"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05


def test_layers_match_reference():
    x = gauss(0, (2, 7, 4, 32))
    w = gauss(1, (32,), 0.1)
    for weight in (None, w):
        np.testing.assert_allclose(
            npy(layers.rms_norm(tt(x), None if weight is None else tt(w))),
            np.asarray(ref_layers.rms_norm(x, weight)), atol=LAYER_TOL)
    pos = np.arange(7, dtype=np.int32)
    for theta in (10_000.0, 500_000.0):
        np.testing.assert_allclose(
            npy(layers.apply_rope(tt(x), tt(pos), theta)),
            np.asarray(ref_layers.apply_rope(x, pos, theta)), atol=LAYER_TOL)
    h = gauss(2, (2, 5, 16))
    p = {"mlp/w_gate": gauss(3, (16, 24), 0.25),
         "mlp/w_up": gauss(4, (16, 24), 0.25),
         "mlp/w_down": gauss(5, (24, 16), 0.2)}
    np.testing.assert_allclose(
        npy(layers.apply_mlp({k: tt(v) for k, v in p.items()}, tt(h),
                             prefix="mlp")),
        np.asarray(ref_layers.apply_mlp(p, h, prefix="mlp")), atol=LAYER_TOL)
    s = gauss(6, (3, 50), 40.0)
    for cap in (0.0, 30.0, 50.0):
        np.testing.assert_allclose(npy(layers.softcap(tt(s), cap)),
                                   np.asarray(ref_layers.softcap(s, cap)),
                                   atol=LAYER_TOL * 50, rtol=LAYER_TOL)


# (spec, t, head_dim): each branch of attention_prefill
BRANCHES = [
    (LayerSpec(attn=ATTN_FULL), 256, 12),                 # query-chunked loop
    (LayerSpec(attn=ATTN_SLIDING, window=64), 256, 12),   # sliding band loop
    (LayerSpec(attn=ATTN_CHUNKED, window=64), 256, 16),   # block-diagonal
    (LayerSpec(attn=ATTN_CHUNKED, window=48), 100, 16),   # one masked sdpa
    (LayerSpec(attn=ATTN_SLIDING, window=64), 100, 16),   # one masked sdpa
    (LayerSpec(attn=ATTN_SLIDING, window=64), 256, 16),   # kernel branch
    (LayerSpec(attn=ATTN_FULL), 128, 32),                 # kernel branch
]


@pytest.mark.parametrize("spec,t,dh", BRANCHES)
def test_attention_prefill_branches_match_reference(spec, t, dh):
    rcfg = ref_configs.get_reduced("gemma2-2b").replace(head_dim=dh)
    cfg = configs.get_reduced("gemma2-2b").replace(head_dim=dh)
    ref_spec = ref_configs.LayerSpec(attn=spec.attn, window=spec.window)
    q, k, v = gauss(0, (2, t, 4, dh)), gauss(1, (2, t, 2, dh)), \
        gauss(2, (2, t, 2, dh))
    out = npy(attention.attention_prefill(cfg, spec, tt(q), tt(k), tt(v)))
    want = ref_attn.attention_prefill(rcfg, ref_spec, q, k, v)
    np.testing.assert_allclose(out, np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", [128, 40])
def test_forward_logits_match_reference(arch, t):
    rcfg, cfg, rp, p = reference_lm(arch)
    toks = tokens(1, 2, t, cfg.vocab_size)
    out, cache, aux = model.forward(cfg, p, {"tokens": tt(toks).long()})
    assert cache is None and float(aux) == 0.0
    assert out.dtype == torch.float32 and out.shape == (2, t, cfg.vocab_size)
    flags = (False, True) if t % 128 == 0 else (False,)
    for flag in flags:
        ref_attn.USE_FLASH_KERNEL = flag
        try:
            want, _, _ = ref_model.forward(rcfg, rp, {"tokens": toks})
        finally:
            ref_attn.USE_FLASH_KERNEL = False
        np.testing.assert_allclose(npy(out), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=0)


def test_qk_norm_forward_matches_reference():
    """The qk-norm branch of the attention block (gemma3-style), on a
    reduced llama with learned q/k norm scales."""
    rcfg = ref_configs.get_reduced("llama3.2-1b").replace(qk_norm=True)
    cfg = configs.get_reduced("llama3.2-1b").replace(qk_norm=True)
    rp, _ = ref_model.init_lm(rcfg, jax.random.PRNGKey(3))
    rp = {k: np.asarray(v) for k, v in rp.items()}
    rng = np.random.default_rng(9)
    for k in rp:
        if k.endswith("norm/scale"):
            rp[k] = (0.3 * rng.standard_normal(rp[k].shape)).astype(np.float32)
    p, _ = model.init_lm(cfg, device="cpu")
    assert sorted(p) == sorted(rp)
    toks = tokens(8, 2, 128, cfg.vocab_size)
    out, _, _ = model.forward(cfg, lm_params_from_numpy(rp, "cpu"),
                              {"tokens": tt(toks).long()})
    want, _, _ = ref_model.forward(rcfg, rp, {"tokens": toks})
    np.testing.assert_allclose(npy(out), np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)


def test_lm_loss_matches_reference():
    rcfg, cfg, rp, p = reference_lm("llama3.2-1b")
    toks = tokens(2, 2, 40, cfg.vocab_size)
    loss, aux = model.lm_loss(cfg, p, {"tokens": tt(toks).long()})
    want, want_aux = ref_model.lm_loss(rcfg, rp, {"tokens": toks})
    np.testing.assert_allclose(float(loss), float(want), atol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(want_aux["ce"]),
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Prefill 128 tokens into a cache, then 8 decode steps; logits at
    every step and the caches at the end. gemma2's reduced local layer has
    a window-64 ring: the prefill takes the t_new >= s roll and the decode
    writes wrap around it."""
    rcfg, cfg, rp, p = reference_lm(arch)
    b, t, max_seq, steps = 2, 128, 160, 8
    toks = tokens(3, b, t, cfg.vocab_size)
    nxt = tokens(4, b, steps, cfg.vocab_size)

    rcache = ref_model.init_cache(rcfg, b, max_seq)
    rlog, rcache, _ = ref_model.forward(rcfg, rp, {"tokens": toks},
                                        cache=rcache, write_pos=0)
    cache = model.init_cache(cfg, b, max_seq, device="cpu")
    assert sorted(cache) == sorted(rcache)
    log, cache, _ = model.forward(cfg, p, {"tokens": tt(toks).long()},
                                  cache=cache, write_pos=0)
    np.testing.assert_allclose(npy(log), np.asarray(rlog), atol=LOGIT_TOL,
                               rtol=0)
    for key in rcache:
        np.testing.assert_allclose(npy(cache[key]), np.asarray(rcache[key]),
                                   atol=LOGIT_TOL, rtol=0, err_msg=key)
    if arch == "gemma2-2b":
        assert cache["body/0/attn/k"].shape[2] == 64   # the window ring

    ref_step = jax.jit(partial(ref_model.decode_step, rcfg))
    for i in range(steps):
        rl, rcache = ref_step(rp, nxt[:, i:i + 1], np.int32(t + i), rcache)
        lg, cache = model.decode_step(cfg, p, tt(nxt[:, i:i + 1]).long(),
                                      t + i, cache)
        assert lg.shape == (b, 1, cfg.vocab_size)
        np.testing.assert_allclose(npy(lg), np.asarray(rl), atol=LOGIT_TOL,
                                   rtol=0, err_msg=f"step {i}")
    for key in rcache:
        np.testing.assert_allclose(npy(cache[key]), np.asarray(rcache[key]),
                                   atol=LOGIT_TOL, rtol=0, err_msg=key)


def test_decode_continues_from_a_carried_reference_cache():
    """A reference cache carried across with ``cache_from_numpy`` decodes
    in the port as it does in the reference."""
    rcfg, cfg, rp, p = reference_lm("gemma2-2b")
    toks = tokens(5, 1, 70, cfg.vocab_size)
    rcache = ref_model.init_cache(rcfg, 1, 96)
    _, rcache, _ = ref_model.forward(rcfg, rp, {"tokens": toks},
                                     cache=rcache)
    cache = cache_from_numpy({k: np.asarray(v) for k, v in rcache.items()},
                             "cpu")
    tok = tokens(6, 1, 1, cfg.vocab_size)
    rl, _ = ref_model.decode_step(rcfg, rp, tok, 70, rcache)
    lg, _ = model.decode_step(cfg, p, tt(tok).long(), 70, cache)
    np.testing.assert_allclose(npy(lg), np.asarray(rl), atol=LOGIT_TOL,
                               rtol=0)


def test_cache_from_numpy_carries_bf16_bits():
    """A bf16 reference cache arrives as ml_dtypes' bfloat16 in numpy; the
    bits cross unchanged."""
    a = jax.numpy.asarray(gauss(3, (2, 5, 2, 4), 10.0)).astype(
        jax.numpy.bfloat16)
    got = cache_from_numpy({"body/0/attn/k": np.asarray(a)}, "cpu")
    t = got["body/0/attn/k"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(npy(t.float()),
                                  np.asarray(a.astype(jax.numpy.float32)))


def test_write_attn_cache_ring_matches_reference():
    """Writes that wrap around the ring and writes longer than it."""
    s = 8
    for pos, t_new in ((0, 3), (6, 5), (13, 8), (5, 20), (0, 8)):
        base = gauss(pos, (1, s, 2, 4))
        new = gauss(100 + pos, (1, t_new, 2, 4))
        want = ref_attn.write_attn_cache({"k": base, "v": base}, new, new,
                                         pos)
        got = attention.write_attn_cache({"k": tt(base), "v": tt(base)},
                                         tt(new), tt(new), pos)
        for name in ("k", "v"):
            np.testing.assert_array_equal(npy(got[name]),
                                          np.asarray(want[name]))
        np.testing.assert_array_equal(
            npy(attention.ring_positions(s, pos + t_new)),
            np.asarray(ref_attn.ring_positions(s, pos + t_new)))
