"""The port's ``ServeEngine`` against the reference's, greedy, at reduced
widths, and the serve CLI on the CPU.

At random init the embeddings are tied and scaled by sqrt(d), so greedy
decoding echoes the last prompt token and equal tokens would prove little.
Both packages therefore serve the same weights with ``embed/tok`` scaled
by 0.02, where the tokens vary, and the test holds the logits of every
prefill and decode step (≤ 1e-4 absolute, fp32 configs) as well as the
tokens. The port's logits come from ``ServeEngine.run``'s ``on_step``
hook. The reference's are recorded by wrapping its engine's ``_prefill``
and replacing its jitted greedy ``_decode`` with one that returns the same
argmax and keeps the logits; a second, unpatched reference engine gives the
tokens.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import npy
from test_torch_lm import reference_lm
from repro.models import model as ref_model
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine
from repro_torch.launch import serve
from repro_torch.serving import Request, ServeEngine

LOGIT_TOL = 1e-4


def prompts(seed, n, vocab, lo=4, hi=40, extra=()):
    rng = np.random.default_rng(seed)
    out = [rng.integers(1, vocab, int(rng.integers(lo, hi))).tolist()
           for _ in range(n)]
    return out + [rng.integers(1, vocab, t).tolist() for t in extra]


def record_reference(rcfg, rp, ps, max_new, max_seq, eos=-1):
    eng = RefEngine(rcfg, rp, max_batch=4, max_seq=max_seq, temperature=0.0)
    logits = []
    prefill = eng._prefill

    def rec_prefill(prompts_np):
        last, cache = prefill(prompts_np)
        logits.append(np.asarray(last))
        return last, cache

    step = jax.jit(partial(ref_model.decode_step, rcfg))

    def rec_decode(params, tok, pos, cache, key):
        lg, cache = step(params, tok, pos, cache)
        logits.append(np.asarray(lg[:, -1]))
        return jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32), cache

    eng._prefill, eng._decode = rec_prefill, rec_decode
    for p in ps:
        eng.submit(RefRequest(prompt=p, max_new_tokens=max_new, eos_id=eos))
    return eng.run(jax.random.PRNGKey(0)), logits


def record_port(cfg, p, ps, max_new, max_seq, eos=-1, temperature=0.0,
                generator=None):
    eng = ServeEngine(cfg, p, max_batch=4, max_seq=max_seq,
                      temperature=temperature)
    logits, steps = [], []

    def on_step(step, lg):
        steps.append(step)
        logits.append(npy(lg))

    for q in ps:
        eng.submit(Request(prompt=q, max_new_tokens=max_new, eos_id=eos))
    done = eng.run(generator, on_step=on_step)
    # each batch: its prefill (step 0), then its decode steps 1, 2, ...
    starts = [i for i, st in enumerate(steps) if st == 0]
    assert starts[0] == 0 and len(starts) == -(-len(ps) // 4)
    assert all(steps[i] == steps[i - 1] + 1 for i in range(1, len(steps))
               if i not in starts)
    return done, logits


@pytest.mark.parametrize("arch,extra", [("gemma2-2b", (128,)),
                                        ("llama3.2-1b", ())])
def test_greedy_serving_matches_reference(arch, extra):
    """Two batches (the second with a 128-token prompt on gemma2: the
    prefill's kernel branch and the window ring's roll)."""
    rcfg, cfg, rp, p = reference_lm(arch, embed_scale=0.02)
    ps = prompts(0, 5 if extra else 6, cfg.vocab_size, extra=extra)
    max_new, max_seq = 8, 160
    ref_done, ref_logits = record_reference(rcfg, rp, ps, max_new, max_seq)
    done, logits = record_port(cfg, p, ps, max_new, max_seq)

    plain = RefEngine(rcfg, rp, max_batch=4, max_seq=max_seq)
    for q in ps:
        plain.submit(RefRequest(prompt=q, max_new_tokens=max_new))
    plain_done = plain.run(jax.random.PRNGKey(0))

    assert len(logits) == len(ref_logits) == 2 * max_new
    for i, (a, b) in enumerate(zip(logits, ref_logits)):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"step {i}")
    got = [r.out_tokens for r in done]
    assert got == [r.out_tokens for r in ref_done]
    assert got == [r.out_tokens for r in plain_done]
    assert all(len(t) == max_new for t in got)
    # the scaled embeddings make the tokens vary (no pure echo)
    assert len({t for toks in got for t in toks}) > len(got)


def test_eos_and_max_seq_bound_match_reference():
    """EOS stops a request early; the decode loop is bounded by
    max_seq - plen - 1."""
    rcfg, cfg, rp, p = reference_lm("gemma2-2b", embed_scale=0.02)
    ps = prompts(1, 3, cfg.vocab_size, lo=20, hi=30)
    first, _ = record_port(cfg, p, ps, 6, 96)
    eos = first[0].out_tokens[2]
    ref_done, _ = record_reference(rcfg, rp, ps, 6, 96, eos=eos)
    done, _ = record_port(cfg, p, ps, 6, 96, eos=eos)
    assert [r.out_tokens for r in done] == [r.out_tokens
                                             for r in ref_done]
    assert done[0].out_tokens[-1] == eos and len(done[0].out_tokens) <= 3
    short, _ = record_port(cfg, p, ps, 20, 33)
    ref_short, _ = record_reference(rcfg, rp, ps, 20, 33)
    assert [r.out_tokens for r in short] == [r.out_tokens
                                              for r in ref_short]
    plen = max(len(q) for q in ps)
    assert len(short[0].out_tokens) == 1 + (33 - plen - 1)


def test_temperature_sampling_is_seeded():
    _, cfg, _, p = reference_lm("llama3.2-1b", embed_scale=0.02)
    ps = prompts(2, 4, cfg.vocab_size)

    def sample(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        done, _ = record_port(cfg, p, ps, 8, 96, temperature=0.8,
                              generator=g)
        return [r.out_tokens for r in done]

    a, b, c = sample(0), sample(0), sample(1)
    assert a == b and a != c
    assert all(len(t) == 8 and all(0 <= x < cfg.vocab_size for x in t)
               for t in a)
    greedy, _ = record_port(cfg, p, ps, 8, 96)
    assert a != [r.out_tokens for r in greedy]


def test_from_algorithm_serves_eval_params():
    _, cfg, _, p = reference_lm("olmo-1b")

    class Alg:
        def eval_params(self, state):
            return state

    eng = ServeEngine.from_algorithm(cfg, Alg(), p, max_seq=64)
    assert eng.params is p and eng.device == torch.device("cpu")


def test_serve_cli_on_the_cpu(capsys):
    done = serve.main(["--arch", "gemma2-2b", "--device", "cpu",
                       "--requests", "5", "--max-new", "4"])
    assert len(done) == 5 and all(len(r.out_tokens) == 4 for r in done)
    assert "served 5 requests, 20 tokens" in capsys.readouterr().out
    # --from-algo: two QuAFL rounds on the LM token task, then serve the
    # run's eval_params
    done = serve.main(["--arch", "llama3.2-1b", "--device", "cpu",
                       "--from-algo", "quafl", "--algo-rounds", "2",
                       "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "serving eval_params of a quafl run (2 rounds, sim_t=22)" in out
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
