"""The rest of the decoder zoo in the port (the Mamba2 SSD block, the MoE
block, the MLA block; gemma3-12b, mamba2-370m, llama4-scout-17b-a16e,
deepseek-v2-236b and jamba-1.5-large-398b) against the JAX reference at
the reduced configs.

Weights come from the port's init (``port_lm``) or, where the reference's
own init matters (the SSD case, serving), from the reference's
(``reference_lm``), carried across key for key as numpy (into the port
with ``utils/interop.lm_params_from_numpy``); inputs are made from numpy
seeds
(each arch's forward, decode, loss and gradient:
``tests/test_torch_zoo_archs.py``; federated training:
``tests/test_torch_zoo_train.py``). The reduced configs are fp32 throughout.
Tolerances, relative to max |want| unless they say otherwise:

* blocks (Mamba prefill and decode, MoE ragged and dense, MLA prefill and
  absorbed decode): 1e-5;
* the SSD case and serving: logits within 1e-4, greedy tokens equal;
* routing is discontinuous: the MoE tests assert a margin between the
  k-th and the (k+1)-th routing probability on their inputs, so that fp32
  noise cannot flip an expert choice.

The SSD case: the reference's intra-chunk decay overflows to inf above the
diagonal and multiplies it by 0 (``src/repro/models/mamba.py:93-97``), so
its logits are NaN on all-ones tokens once t reaches the chunk; the port
masks before the exponential and stays finite, and equals the reference
where the reference is finite.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import gauss, npy, tt
from test_torch_lm import tokens
from repro import configs as ref_configs
from repro.models import mamba as ref_mamba
from repro.models import mla as ref_mla
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.models import mamba, mla, model, moe
from repro_torch.serving import Request, ServeEngine
from repro_torch.utils.interop import cache_from_numpy, lm_params_from_numpy

ZOO = ["gemma3-12b", "mamba2-370m", "llama4-scout-17b-a16e",
       "deepseek-v2-236b", "jamba-1.5-large-398b"]
BLOCK_TOL, LOGIT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-5, 1e-4
ROUTE_MARGIN = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced widths gain nothing from intra-op threads, and the suite's
    workers share the machine's cores: one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_LM = {}


def reference_lm(arch, seed=0):
    """(reference cfg, port cfg, the reference's ``init_lm`` params as
    numpy, the port's copy), made once an (arch, seed) in this module; the
    reference's init runs jitted (one compile, not one an op)."""
    if (arch, seed) not in _LM:
        rcfg = ref_configs.get_reduced(arch)
        rp = jax.jit(lambda k: ref_model.init_lm(rcfg, k)[0])(
            jax.random.PRNGKey(seed))
        rp = {k: np.asarray(v) for k, v in rp.items()}
        _LM[arch, seed] = (rcfg, configs.get_reduced(arch), rp,
                           lm_params_from_numpy(rp, "cpu"))
    return _LM[arch, seed]


def port_lm(arch, seed=0):
    """(reference cfg, port cfg, params as numpy, the port's params): the
    port's ``init_lm`` (its keys, shapes and init kinds are held against
    the reference's by ``test_init_lm_keys_shapes_axes_match_reference``),
    made once an (arch, seed) in this module; both sides of a parity test
    run on these numbers."""
    if (arch, seed, "port") not in _LM:
        cfg = configs.get_reduced(arch)
        pp, _ = model.init_lm(cfg, seed=seed, device="cpu")
        _LM[arch, seed, "port"] = (ref_configs.get_reduced(arch), cfg,
                                   {k: npy(v) for k, v in pp.items()}, pp)
    return _LM[arch, seed, "port"]


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    err = float(np.abs(npy(got).astype(np.float32) - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, (what, err, scale)


def _ref_sub(params, prefix):
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


# ---------------------------------------------------------------------------
# the registry and the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ZOO)
def test_config_fields_match_reference(arch):
    """Every field of the port's ModelConfig, the block configs and the
    layer specs included, equals the reference's, for config() and
    reduced()."""
    assert arch in configs.list_archs()
    for get in ("get_config", "get_reduced"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(configs, get)(arch)
        for f in dataclasses.fields(port):
            got, want = getattr(port, f.name), getattr(ref, f.name)
            if isinstance(got, tuple):
                got, want = [_as_dict(s) for s in got], [_as_dict(s)
                                                        for s in want]
            assert _as_dict(got) == _as_dict(want), (arch, get, f.name)
        assert port.n_periods == ref.n_periods


@pytest.mark.parametrize("arch", ZOO)
def test_init_lm_keys_shapes_axes_match_reference(arch):
    rcfg, cfg = ref_configs.get_reduced(arch), configs.get_reduced(arch)
    ref_p, ref_axes = ref_model.abstract_lm(rcfg)
    p, axes = model.init_lm(cfg, seed=0, device="cpu")
    assert sorted(p) == sorted(ref_p)
    assert axes == {k: tuple(v) for k, v in ref_axes.items()}
    for k, v in ref_p.items():
        assert tuple(p[k].shape) == tuple(v.shape), k
        assert str(p[k].dtype) == f"torch.{v.dtype}", k
    for k, v in p.items():
        # the Mamba inits: A in [1, 16], dt in [1e-3, 1e-1], D ones
        if k.endswith("mamba/A_log"):
            a = torch.exp(v)
            assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
        elif k.endswith("mamba/dt_bias"):
            dt = torch.nn.functional.softplus(v)
            assert float(dt.min()) >= 1e-3 - 1e-7
            assert float(dt.max()) <= 1e-1 + 1e-7
        elif k.endswith("mamba/D"):
            assert torch.equal(v, torch.ones_like(v))
    again, _ = model.init_lm(cfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _layer_params(arch, prefix, seed=0):
    """(reference cfg, port cfg, the params of the layer at ``prefix``
    (numpy), the port's)."""
    rcfg, cfg, rp, _ = port_lm(arch, seed)
    if prefix.startswith("body/"):
        rp = {k: v[0] for k, v in _ref_sub(rp, prefix).items()}
    else:
        rp = _ref_sub(rp, prefix)
    rng = np.random.default_rng(seed + 50)
    for k in rp:     # learned norm scales, not their zero init
        if k.endswith("norm/scale"):
            rp[k] = (0.3 * rng.standard_normal(rp[k].shape)).astype(
                np.float32)
    return rcfg, cfg, rp, lm_params_from_numpy(rp, "cpu")


@pytest.mark.parametrize("arch,t", [("mamba2-370m", 40),
                                    ("jamba-1.5-large-398b", 64)])
def test_mamba_prefill_and_decode_match_reference(arch, t):
    """A prefill of t tokens (t = 40 pads the last chunk of 32) from a
    nonzero SSM state, then three recurrent steps; outputs and both
    states."""
    rcfg, cfg, rp, p = _layer_params(arch, "body/0")
    b = 2
    x = gauss(1, (b, t, cfg.d_model), 0.5)
    ssm0 = gauss(2, (b,) + tuple(mamba.init_mamba_cache(
        cfg, b, "meta")["ssm"].shape[1:]), 0.1)
    conv0 = np.zeros(tuple(mamba.init_mamba_cache(cfg, b, "meta")[
        "conv"].shape), np.float32)
    rc = {"conv": conv0, "ssm": ssm0}
    want, rc = jax.jit(partial(ref_mamba.mamba_prefill, rcfg,
                               prefix="mamba"))(rp, x, cache=rc)
    assert np.isfinite(np.asarray(want)).all()
    pc = {"conv": tt(conv0), "ssm": tt(ssm0)}
    got = mamba.mamba_prefill(cfg, p, tt(x), prefix="mamba", cache=pc)
    _close(got, want, BLOCK_TOL, "prefill")
    for k in pc:
        _close(pc[k], rc[k], BLOCK_TOL, k)
    ref_step = jax.jit(partial(ref_mamba.mamba_decode, rcfg, prefix="mamba"))
    for i in range(3):
        xi = gauss(10 + i, (b, 1, cfg.d_model), 0.5)
        want, rc = ref_step(rp, xi, rc)
        got = mamba.mamba_decode(cfg, p, tt(xi), pc, prefix="mamba")
        _close(got, want, BLOCK_TOL, f"decode {i}")
        for k in pc:
            _close(pc[k], rc[k], BLOCK_TOL, f"{k} {i}")


def _route_margin(rcfg, rp, x):
    """The smallest gap between the k-th and (k+1)-th routing
    probabilities of the reference's router over the rows of x."""
    logits = x.reshape(-1, x.shape[-1]) @ rp["moe/router"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    srt = -np.sort(-probs, axis=-1)
    k = rcfg.moe.top_k
    return float((srt[:, k - 1] - srt[:, k]).min())


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("impl", ["ragged", "dense"])
def test_moe_matches_reference(arch, impl):
    """``apply_moe`` (router, top-k, aux, shared experts) at the arch's
    reduced widths. deepseek's dense capacity (int(1.25 · 48 · 2 / 4) = 30
    slots an expert) drops tokens on these inputs, as the reference's."""
    rcfg, cfg, rp, p = _layer_params(arch, "body/0")
    moe_cfg = dataclasses.replace(cfg.moe, impl=impl)
    rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, impl=impl))
    cfg = cfg.replace(moe=moe_cfg)
    x = gauss(3, (2, 24, cfg.d_model))
    assert _route_margin(rcfg, rp, x) > ROUTE_MARGIN
    want, waux = jax.jit(partial(ref_moe.apply_moe, rcfg, prefix="moe"))(
        rp, x)
    got, aux = moe.apply_moe(cfg, p, tt(x), prefix="moe")
    _close(got, want, BLOCK_TOL)
    assert abs(float(aux) - float(waux)) <= LOSS_TOL
    # the router itself: the same experts, the same weights
    rw, ri, _ = ref_moe._router(rcfg, rp, x.reshape(-1, cfg.d_model),
                                "moe/")
    pw, pi, _ = moe._router(cfg, p, tt(x).reshape(-1, cfg.d_model), "moe/")
    assert np.array_equal(npy(pi), np.asarray(ri))
    _close(pw, rw, BLOCK_TOL)


def test_top_k_takes_the_lower_index_first_on_ties():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = moe.top_k(tt(probs), k)
        assert np.array_equal(npy(i), np.asarray(wi))
        assert np.array_equal(npy(v), np.asarray(wv))


@pytest.mark.parametrize("t,b", [(40, 2), (2048, 1)])
def test_mla_prefill_and_absorbed_decode_match_reference(t, b):
    """The expanded prefill (t = 2,048 takes the 1,024-query chunks) into a
    latent cache, then three absorbed decode steps over it."""
    rcfg, cfg, rp, p = _layer_params("deepseek-v2-236b", "pre/0")
    max_seq = t + 8
    x = gauss(4, (b, t, cfg.d_model))
    pos = np.arange(t, dtype=np.int32)
    rc = ref_mla.init_mla_cache(rcfg, b, max_seq, abstract=False)
    want, rc = jax.jit(partial(ref_mla.mla_prefill, rcfg, prefix="mla"))(
        rp, x, pos, cache=rc)
    pc = mla.init_mla_cache(cfg, b, max_seq, "cpu")
    got = mla.mla_prefill(cfg, p, tt(x), tt(pos), prefix="mla", cache=pc)
    _close(got, want, BLOCK_TOL, "prefill")
    for k in pc:
        _close(pc[k], rc[k], BLOCK_TOL, k)
    ref_step = jax.jit(partial(ref_mla.mla_decode, rcfg, prefix="mla"))
    for i in range(3):
        xi = gauss(20 + i, (b, 1, cfg.d_model))
        want, rc = ref_step(rp, xi, np.int32(t + i), rc)
        got = mla.mla_decode(cfg, p, tt(xi), t + i, pc, prefix="mla")
        _close(got, want, BLOCK_TOL, f"decode {i}")
    for k in pc:
        _close(pc[k], rc[k], BLOCK_TOL, k)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_ssd_masks_before_the_exponential(arch):
    """All-ones tokens: at t = 16 (under the chunk of 32) both are finite;
    at t = 32 and 64 the reference's logits are not, the port's are. On
    varied tokens, where the reference is finite, the two agree."""
    rcfg, cfg, rp, p = reference_lm(arch)
    ref_forward = jax.jit(partial(ref_model.forward, rcfg))
    for t in (16, 32, 64):
        toks = np.ones((2, t), np.int32)
        want, _, _ = ref_forward(rp, {"tokens": toks})
        got, _, _ = model.forward(cfg, p, {"tokens": tt(toks).long()})
        assert bool(np.isfinite(np.asarray(want)).all()) == (t < 32), t
        assert bool(torch.isfinite(got).all()), t
    toks = np.tile((7 * np.arange(64) % cfg.vocab_size).astype(np.int32),
                   (2, 1))
    want, _, _ = ref_forward(rp, {"tokens": toks})
    assert np.isfinite(np.asarray(want)).all()
    got, _, _ = model.forward(cfg, p, {"tokens": tt(toks).long()})
    _close(got, want, LOGIT_TOL)
    # the backward of the masked form has no NaN either
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss, _ = model.lm_loss(cfg, leaves, {"tokens": torch.ones(
        (2, 64), dtype=torch.int64)})
    loss.backward()
    assert all(bool(torch.isfinite(v.grad).all()) for v in leaves.values()
               if v.grad is not None)


def test_serving_matches_reference_greedy():
    """``ServeEngine`` on reduced jamba (Mamba, attention and MoE layers),
    prompts of unequal length left-padded with 0 as the reference's:
    greedy tokens equal to the reference engine's."""
    rcfg, cfg, rp, p = reference_lm("jamba-1.5-large-398b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 11)]
    ref = RefServeEngine(rcfg, {k: jnp.asarray(v) for k, v in rp.items()},
                         max_batch=2, max_seq=32)
    eng = ServeEngine(cfg, p, max_batch=2, max_seq=32)
    for pr in prompts:
        ref.submit(RefRequest(prompt=pr, max_new_tokens=6))
        eng.submit(Request(prompt=pr, max_new_tokens=6))
    want = [r.out_tokens for r in ref.run()]
    got = [r.out_tokens for r in eng.run()]
    assert got == want


def test_bf16_caches_carry_across():
    """A reference cache of a bf16 jamba (bf16 conv state and K/V, fp32 SSM
    state) arrives bit for bit, dtype for dtype, through
    ``cache_from_numpy``."""
    rcfg, cfg, rp, p = reference_lm("jamba-1.5-large-398b")
    toks = tokens(8, 2, 20, cfg.vocab_size)
    rbf = rcfg.replace(dtype="bfloat16")
    rcache = ref_model.init_cache(rbf, 2, 24)
    _, rcache, _ = jax.jit(partial(ref_model.forward, rbf))(
        rp, {"tokens": toks}, cache=rcache)
    cache = cache_from_numpy({k: np.asarray(v) for k, v in rcache.items()},
                             "cpu")
    assert sorted(cache) == sorted(model.init_cache(cfg.replace(
        dtype="bfloat16"), 2, 24, device="cpu"))
    dtypes = {k: str(v.dtype) for k, v in cache.items()}
    assert dtypes["body/0/mamba/conv"] == "torch.bfloat16"
    assert dtypes["body/0/mamba/ssm"] == "torch.float32"
    assert dtypes["body/1/attn/k"] == "torch.bfloat16"
    for k, v in rcache.items():
        assert np.array_equal(npy(cache[k].float()),
                              np.asarray(v.astype(jnp.float32))), k
