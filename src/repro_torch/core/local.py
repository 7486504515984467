"""Local SGD of the sampled clients, under the two client protocols.

* **Batched** (no ``batch_fn``; the paper's MLP): the loss is batched over
  a leading client axis (``models.mlp.mlp_loss_batched``), so one autograd
  call per step gives every client's gradient (:func:`batched_grads`,
  :func:`local_sgd`). The minibatches are gathered up front from
  ``data["x"]`` and ``data["y"]``.
* **Per client** (``batch_fn`` given; the reference's protocol, any model):
  ``loss_fn(params, batch) -> (loss, aux)`` of one client and
  ``batch_fn(client_data, rows) -> batch`` building that client's
  minibatch from its (B,) row indices. The clients' gradients are taken one
  client at a time (:func:`client_grad`), so a single client's activations
  are live at once, as an LM at full width needs.

Either way the algorithm draws the (s, K, B) row indices itself, so a test
can inject the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils import spans
from repro_torch.utils.tree import tree_unflatten_vector


def pool_size(data) -> int:
    """Rows per client of the per-client datasets (axis 1 of every
    leaf)."""
    return int(next(iter(data.values())).shape[1])


def client_data(data, i: torch.Tensor):
    """Client ``i``'s rows of every leaf, ``i`` a 0-d or (1,) index tensor
    (no host read, so a captured round can gather it)."""
    i1 = i.reshape(1)
    return {k: v.index_select(0, i1)[0] for k, v in data.items()}


def gather_batches(data, idx: torch.Tensor, rows: torch.Tensor):
    """The batched protocol's minibatches: (s, K, B, ...) ``x`` and (s, K,
    B) ``y`` of the sampled clients ``idx`` at ``rows`` (s, K, B)."""
    sel = idx[:, None, None]
    return data["x"][sel, rows], data["y"][sel, rows]


def batched_grads(loss_fn, template, flat, batch) -> torch.Tensor:
    """Per-client gradients (s, d) of the batched loss at (s, d) ``flat``."""
    v = flat.detach().requires_grad_(True)
    losses, _ = loss_fn(tree_unflatten_vector(template, v), batch)
    (g,) = torch.autograd.grad(losses.sum(), v)
    return g


def local_sgd(loss_fn, template, start, xs, ys, lr: float) -> torch.Tensor:
    """Exactly K SGD steps of every client from ``start`` (s, d); xs (s, K,
    B, ...) and ys (s, K, B) hold each step's minibatch. Returns (s, d)."""
    x = start
    for q in range(xs.shape[1]):
        x = x - lr * batched_grads(loss_fn, template, x,
                                   {"x": xs[:, q], "y": ys[:, q]})
    return x


# ---------------------------------------------------------------------------
# the per-client protocol
# ---------------------------------------------------------------------------

def client_grad(loss_fn, template, flat, batch,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gradient (d,) of one client's ``loss_fn`` at the flat params
    ``flat`` (d,), written into ``out`` when given.

    Autograd runs on the leaves (detached views of ``flat``), and each
    leaf's gradient is copied into its slice of the flat output and then
    dropped: differentiating the flat vector itself would have every
    leaf's backward materialise a zero-filled (d,) tensor."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in tree_unflatten_vector(template,
                                                flat.detach()).items()}
    keys = sorted(leaves)
    loss, _ = loss_fn(leaves, batch)
    grads = list(torch.autograd.grad(loss, [leaves[k] for k in keys],
                                     allow_unused=True))
    out = torch.empty_like(flat) if out is None else out
    off = 0
    for j, k in enumerate(keys):
        n = leaves[k].numel()
        if grads[j] is None:
            out[off:off + n].zero_()
        else:
            out[off:off + n].copy_(grads[j].reshape(-1))
        grads[j] = None
        off += n
    return out


def client_steps(loss_fn, template, batch_fn, x, data_i, rows, lr: float,
                 active=None, correction=None, h=None) -> torch.Tensor:
    """``rows.shape[0]`` SGD steps of one client on ``x`` (d,), IN PLACE;
    step q's minibatch is ``batch_fn(data_i, rows[q])``. ``active`` (K,)
    0/1 masks steps (QuAFL's lazy H_i: a masked step moves nothing);
    ``correction`` (d,) is taken off every gradient (SCAFFOLD); ``h`` (d,),
    when given, accumulates the active steps' gradients. Returns ``x``."""
    g = torch.empty_like(x)
    for q in range(rows.shape[0]):
        with spans.span("local.step", eager_only=True):
            with spans.span("local.grad", eager_only=True):
                client_grad(loss_fn, template, x, batch_fn(data_i, rows[q]),
                            out=g)
            with spans.span("local.update", eager_only=True):
                if correction is not None:
                    g.sub_(correction)
                if active is not None:
                    g.mul_(active[q])
                if h is not None:
                    h.add_(g)
                x.add_(g, alpha=-lr)
    return x


def cohort_progress(loss_fn, template, batch_fn, cl, data, idx, rows,
                    h_steps, lr: float, correction=None) -> torch.Tensor:
    """QuAFL's local replay under the per-client protocol: h̃ (s, d), the
    sum of each sampled client's first H_i step gradients from its model
    ``cl[i]``, one client at a time. ``correction`` (s, d) as in
    :func:`client_steps`."""
    s, K = rows.shape[0], rows.shape[1]
    h = torch.zeros_like(cl)
    steps = torch.arange(K, device=cl.device)
    active = (steps[None, :] < h_steps[:, None]).to(torch.float32)
    for i in range(s):
        client_steps(loss_fn, template, batch_fn, cl[i].clone(),
                     client_data(data, idx[i]), rows[i], lr,
                     active=active[i],
                     correction=None if correction is None
                     else correction[i], h=h[i])
    return h


def cohort_sgd(loss_fn, template, batch_fn, start, data, idx, rows,
               lr: float) -> torch.Tensor:
    """FedAvg's local work under the per-client protocol: every sampled
    client runs exactly K steps from the common ``start`` (d,); returns
    the (s, d) end models, one client at a time."""
    s = rows.shape[0]
    models = start[None].repeat(s, 1)
    for i in range(s):
        client_steps(loss_fn, template, batch_fn, models[i],
                     client_data(data, idx[i]), rows[i], lr)
    return models
