"""The five archs of the rest of the decoder zoo (gemma3-12b, mamba2-370m,
llama4-scout-17b-a16e, deepseek-v2-236b, jamba-1.5-large-398b) in the
port against the JAX reference at the reduced configs, on the port's init
weights carried across to the reference (``tests/test_torch_zoo.py``'s
``port_lm``).

Tolerances, relative to max |want| unless they say otherwise: ``forward``'s
logits, the caches and four decode steps after a prefill within 1e-4;
``lm_loss`` and its ce and aux within 1e-5 absolute; gradients within 1e-4
of the largest gradient.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import npy, tt
from test_torch_lm import tokens
from test_torch_zoo import (GRAD_TOL, LOGIT_TOL, LOSS_TOL, ZOO, _close,
                            one_thread, port_lm)  # noqa: F401
from repro.models import model as ref_model
from repro_torch.models import model


@pytest.mark.parametrize("arch", ZOO)
def test_forward_decode_and_loss_match_reference(arch):
    """``forward``'s logits and aux, a prefill of 40 tokens into a cache
    of 48, four decode steps and the caches after them."""
    rcfg, cfg, rp, p = port_lm(arch)
    b, t, steps = 2, 40, 4
    toks = tokens(1, b, t, cfg.vocab_size)
    nxt = tokens(2, b, steps, cfg.vocab_size)
    rcache = ref_model.init_cache(rcfg, b, t + 8)
    want, rcache, waux = jax.jit(partial(ref_model.forward, rcfg))(
        rp, {"tokens": toks}, cache=rcache)
    cache = model.init_cache(cfg, b, t + 8, device="cpu")
    assert sorted(cache) == sorted(rcache)
    got, cache, aux = model.forward(cfg, p, {"tokens": tt(toks).long()},
                                    cache=cache)
    _close(got, want, LOGIT_TOL, "forward")
    assert abs(float(aux) - float(waux)) <= LOSS_TOL
    assert (float(aux) > 0) == any(s.mlp == "moe"
                                   for s in cfg.prefix + cfg.schedule)
    ref_step = jax.jit(partial(ref_model.decode_step, rcfg))
    for i in range(steps):
        rl, rcache = ref_step(rp, nxt[:, i:i + 1], np.int32(t + i), rcache)
        lg, cache = model.decode_step(cfg, p, tt(nxt[:, i:i + 1]).long(),
                                      t + i, cache)
        _close(lg, rl, LOGIT_TOL, f"step {i}")
    for k in rcache:
        assert cache[k].dtype == getattr(torch, str(rcache[k].dtype)), k
        _close(cache[k], rcache[k], LOGIT_TOL, k)


@pytest.mark.parametrize("arch", ZOO)
def test_lm_loss_gradient_matches_reference(arch):
    """``lm_loss`` (the loss, its ce and aux) and its gradient, ce + aux
    through every block: the SSD's masked exponential, the MoE's grouped
    product and routing weights, MLA's expanded form."""
    rcfg, cfg, rp, pp = port_lm(arch)
    toks = tokens(5, 2, 40, cfg.vocab_size)
    (want_loss, wm), want = jax.jit(jax.value_and_grad(
        lambda q: ref_model.lm_loss(rcfg, q, {"tokens": toks}),
        has_aux=True))({k: jnp.asarray(v) for k, v in rp.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    loss, m = model.lm_loss(cfg, leaves, {"tokens": tt(toks).long()})
    grads = torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)],
                                allow_unused=True)
    for got_v, want_v in ((loss, want_loss), (m["ce"], wm["ce"]),
                          (m["aux"], wm["aux"])):
        assert abs(float(got_v.detach()) - float(want_v)) <= LOSS_TOL
    assert (float(m["aux"]) > 0) == any(s.mlp == "moe"
                                        for s in cfg.prefix + cfg.schedule)
    scale = max(float(np.abs(np.asarray(want[k])).max()) for k in want)
    for k, g in zip(sorted(leaves), grads):
        g = np.zeros_like(rp[k]) if g is None else npy(g)
        err = np.abs(g - np.asarray(want[k])).max()
        assert err <= GRAD_TOL * scale, (arch, k, err, scale)
