"""The paper's MLP classifier (App. A.3) in plain PyTorch: relu(x W1 + b1)
W2 + b2, cross-entropy over each client's minibatch, fp32. Every sampled
client's gradient comes from one batched autograd call."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench import counts
from perfbench.reference.precision import matmul


def leaves(cfg):
    """(name, shape, init scale) in the flat layout's order (sorted
    names); scale 0 is a zero init."""
    d_in, h, c = cfg["d_in"], cfg["d_hidden"], cfg["n_classes"]
    return [("b1", (h,), 0.0), ("b2", (c,), 0.0),
            ("w1", (d_in, h), 1.0 / math.sqrt(d_in)),
            ("w2", (h, c), 1.0 / math.sqrt(h))]


def flops_per_row(cfg, traffic) -> float:
    """Training FLOPs of one minibatch row (a sample)."""
    return counts.mlp_flops_per_sample(sum(math.prod(s) for _, s, _ in
                                           leaves(cfg)))


def _unflatten(cfg, v):
    out, off = {}, 0
    for name, shape, _ in leaves(cfg):
        n = math.prod(shape)
        out[name] = v[:, off:off + n].reshape(v.shape[0], *shape)
        off += n
    return out


def batched_grad(cfg, v, x, y, mode):
    """Per-client gradients (s, d) at the (s, d) models ``v`` of the mean
    cross-entropy over each client's rows x (s, B, d_in), y (s, B)."""
    v = v.detach().requires_grad_(True)
    p = _unflatten(cfg, v)
    h = torch.relu(matmul(x, p["w1"], mode) + p["b1"][:, None])
    logits = matmul(h, p["w2"], mode) + p["b2"][:, None]
    s, b, c = logits.shape
    per = F.cross_entropy(logits.reshape(s * b, c), y.reshape(s * b),
                          reduction="none").reshape(s, b).mean(1)
    (g,) = torch.autograd.grad(per.sum(), v)
    return g


def make_progress(cfg, data, lr: float, mode: str, fault=None):
    """The polled clients' h~, all at once: ``data`` {'x': (n, m, d_in),
    'y': (n, m)}."""
    def progress(cl, idx, rows, active):
        if fault == "half_batch":
            rows = rows[..., :rows.shape[-1] // 2]
        sel = idx[:, None, None]
        xs, ys = data["x"][sel, rows], data["y"][sel, rows]
        x, h = cl.clone(), torch.zeros_like(cl)
        for q in range(rows.shape[1]):
            g = batched_grad(cfg, x, xs[:, q], ys[:, q], mode)
            act = active[:, q:q + 1]
            x = x - lr * act * g
            h = h + act * g
        return h
    return progress
