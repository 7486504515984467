"""A dense decoder-only LM in plain PyTorch and fp32, as the benchmark's
configuration files state it: token embedding (times sqrt(d_model) when
the head is tied), then per layer a non-parametric RMSNorm, causal
multi-head attention with half-split RoPE, a residual, a non-parametric
RMSNorm, a SwiGLU MLP and a residual; a final RMSNorm and the tied head;
next-token cross-entropy. Matrix products take the stated precision
(``precision.matmul``), and so do the activations a bf16 program holds in
bf16 (``precision.act``: the residual stream, norm outputs, projections,
attention outputs, logits); inside the norms, RoPE, the attention scores
and the softmax the arithmetic is fp32. In ``float32`` everything is
fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.reference.precision import act, matmul


def leaves(cfg):
    """(name, shape, init scale) of every parameter, sorted by name: the
    flat layout's order. Stacked layers lead with the layer axis."""
    L, d, f = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    qd = cfg["n_heads"] * cfg["head_dim"]
    kvd = cfg["n_kv_heads"] * cfg["head_dim"]
    if not cfg["tie_embeddings"]:
        raise ValueError("the decoder reference ties its head")
    out = [("body/0/attn/wk", (L, d, kvd), 1 / math.sqrt(d)),
           ("body/0/attn/wo", (L, qd, d), 1 / math.sqrt(qd)),
           ("body/0/attn/wq", (L, d, qd), 1 / math.sqrt(d)),
           ("body/0/attn/wv", (L, d, kvd), 1 / math.sqrt(d)),
           ("body/0/mlp/w_down", (L, f, d), 1 / math.sqrt(f)),
           ("body/0/mlp/w_gate", (L, d, f), 1 / math.sqrt(d)),
           ("body/0/mlp/w_up", (L, d, f), 1 / math.sqrt(d)),
           ("embed/tok", (cfg["vocab_size"], d), 1 / math.sqrt(d))]
    return sorted(out)


def flops_per_row(cfg, traffic) -> float:
    """Training FLOPs of one minibatch row: seq tokens."""
    t = traffic["seq"]
    mm = counts.lm_matmul_params(cfg["n_layers"], cfg["d_model"],
                                 cfg["n_heads"], cfg["n_kv_heads"],
                                 cfg["head_dim"], cfg["d_ff"],
                                 cfg["vocab_size"])
    return t * counts.lm_flops_per_token(cfg["n_layers"], cfg["d_model"], mm,
                                         t)


def _rms(x, eps=1e-6):
    return x * torch.rsqrt(torch.mean(torch.square(x), -1, keepdim=True)
                           + eps)


def _rope(x, theta: float):
    """x (B, T, heads, dh): rotate the two halves by position angles."""
    t, dh = x.shape[1], x.shape[-1]
    freqs = torch.as_tensor(
        1.0 / (theta ** (np.arange(0, dh // 2, dtype=np.float32) * 2.0
                         / dh)), dtype=torch.float32, device=x.device)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = torch.chunk(x, 2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def loss(cfg, p, tokens, mode: str):
    """Mean next-token cross-entropy of (B, T) ``tokens``."""
    B, T = tokens.shape
    H, KV, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    emb = p["embed/tok"]

    def a_(t):
        return act(t, mode)

    def mm(t, w):
        return a_(matmul(t, w, mode))

    x = a_(a_(F.embedding(tokens.long(), emb)) * math.sqrt(cfg["d_model"]))
    causal = torch.ones((T, T), dtype=torch.bool,
                        device=x.device).tril_()
    for li in range(cfg["n_layers"]):
        h = a_(_rms(x))
        q = mm(h, p["body/0/attn/wq"][li]).reshape(B, T, H, dh)
        k = mm(h, p["body/0/attn/wk"][li]).reshape(B, T, KV, dh)
        v = mm(h, p["body/0/attn/wv"][li]).reshape(B, T, KV, dh)
        q = a_(_rope(q, cfg["rope_theta"]))
        k = a_(_rope(k, cfg["rope_theta"]))
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
        probs = torch.softmax(scores.masked_fill(~causal, -1e30), -1)
        o = a_(torch.einsum("bhts,bshd->bthd", probs, v)
               .reshape(B, T, H * dh))
        x = a_(x + mm(o, p["body/0/attn/wo"][li]))
        h = a_(_rms(x))
        g = a_(F.silu(mm(h, p["body/0/mlp/w_gate"][li]))
               * mm(h, p["body/0/mlp/w_up"][li]))
        x = a_(x + mm(g, p["body/0/mlp/w_down"][li]))
    logits = mm(a_(_rms(x)), emb.t())
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def grad(cfg, flat, tokens, mode, probe=None):
    """The gradient (d,) of the loss at the flat parameters ``flat``; a
    :class:`compare.FirstSteps` ``probe`` records the step."""
    p, off, names = {}, 0, []
    for name, shape, _ in leaves(cfg):
        n = math.prod(shape)
        p[name] = flat[off:off + n].view(shape).detach().requires_grad_(True)
        names.append(name)
        off += n
    rec = probe.begin() if probe is not None else None
    value = loss(cfg, p, tokens, mode)
    gs = list(torch.autograd.grad(value, [p[k] for k in names]))
    if probe is not None:
        probe.loss(value)
        if rec is not None:
            for k, g in zip(names, gs):
                probe.put(rec, k, g)
    out, off = torch.empty_like(flat), 0
    for j in range(len(gs)):
        n = gs[j].numel()
        out[off:off + n] = gs[j].reshape(-1)
        gs[j] = None
        off += n
    return out


def make_progress(cfg, data, lr: float, mode: str, fault=None, probe=None):
    """The polled clients' h~, one client at a time: ``data`` {'tokens':
    (n, pool, seq)}; ``probe`` records the steps (``grad``)."""
    from perfbench.reference.quafl import local_progress

    def one(x, i, r, idx):
        if fault == "half_batch":
            r = r[:r.shape[0] // 2]
        return grad(cfg, x, data["tokens"][idx[i]][r], mode, probe)

    def progress(cl, idx, rows, active):
        return local_progress(lambda x, i, r: one(x, i, r, idx), cl, idx,
                              rows, active, lr)
    return progress
