"""GQA attention: full / sliding-window / chunked-local, prefill + decode
(port of ``repro.models.attention``).

Prefill takes the flash-attention kernel of
:mod:`repro_torch.kernels.flash_attention` under the reference's condition
(not chunked, t % 128 == 0, head_dim % 8 == 0) when no gradient is taken;
otherwise the plain branches run as in the reference: block-diagonal
chunks, one masked ``sdpa``, or a loop over query chunks (with the sliding
band). Under autograd (``q.requires_grad``, the LM loss in training) the
plain branches always run: the kernel has no backward, and the reference
trains through its plain branches too (its ``USE_FLASH_KERNEL`` is
False). Decode
attends over a ring-buffer KV cache with the plain :func:`sdpa`.

Caches are written in place: :func:`write_attn_cache` fills the given
tensors (views into the stacked cache of :mod:`repro_torch.models.model`)
and returns them, where the reference returns new arrays; a KV cache at
serve size is the largest state of a decode, and copying it for every
token would double its traffic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTN_CHUNKED, ATTN_SLIDING
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, rms_norm, softcap
from repro_torch.models.params import torch_dtype

NEG_INF = -1e30


def init_attention(ctx, cfg):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ctx.param("wq", (d, h * dh), ("embed", "q_flat"))
    ctx.param("wk", (d, kv * dh), ("embed", "kv_flat"))
    ctx.param("wv", (d, kv * dh), ("embed", "kv_flat"))
    ctx.param("wo", (h * dh, d), ("q_flat", "embed"))
    if cfg.qk_norm:
        ctx.param("q_norm/scale", (dh,), (None,), init="zeros")
        ctx.param("k_norm/scale", (dh,), (None,), init="zeros")


def _qkv(cfg, p, x, positions, use_rope: bool, prefix: str = "",
         theta: float = 0.0):
    pre = prefix + "/" if prefix else ""
    b, t, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p[f"{pre}wq"].to(x.dtype)).reshape(b, t, h, dh)
    k = (x @ p[f"{pre}wk"].to(x.dtype)).reshape(b, t, kv, dh)
    v = (x @ p[f"{pre}wv"].to(x.dtype)).reshape(b, t, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{pre}q_norm/scale"])
        k = rms_norm(k, p[f"{pre}k_norm/scale"])
    if use_rope and positions is not None:
        th = theta or cfg.rope_theta
        q = apply_rope(q, positions, th)
        k = apply_rope(k, positions, th)
    return q, k, v


def sdpa(q, k, v, mask, scale: float, attn_cap: float = 0.0):
    """q: (b, tq, h, dh); k, v: (b, tk, kv, dh); mask: (b?, tq, tk) bool.
    Scores, softmax and the value sum in fp32, out in q's dtype."""
    b, tq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, dh).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg,
                          k.to(torch.float32)) * scale
    scores = softcap(scores, attn_cap)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.to(torch.float32))
    return out.reshape(b, tq, h, dh).to(q.dtype)


def _pick_chunk(t: int) -> int:
    for c in (2048, 1024, 512, 256, 128):
        if t % c == 0 and t > c:
            return c
    return t


def attention_prefill(cfg, spec, q, k, v):
    """Causal self-attention over a full sequence (prefill)."""
    b, t, h, dh = q.shape
    scale = 1.0 / np.sqrt(dh)
    window = spec.window
    dev = q.device

    if (spec.attn != ATTN_CHUNKED and t % 128 == 0 and dh % 8 == 0
            and not q.requires_grad):
        return flash_attention(
            q, k, v, causal=True,
            window=window if spec.attn == ATTN_SLIDING else 0,
            softcap=cfg.attn_softcap)

    if spec.attn == ATTN_CHUNKED and window and t % window == 0 and t > window:
        # block-diagonal: reshape into (chunks, window) and attend per chunk
        nc = t // window
        qc = q.reshape(b * nc, window, h, dh)
        kc = k.reshape(b * nc, window, k.shape[2], dh)
        vc = v.reshape(b * nc, window, v.shape[2], dh)
        pos = torch.arange(window, device=dev)
        mask = pos[:, None] >= pos[None, :]
        out = sdpa(qc, kc, vc, mask, scale, cfg.attn_softcap)
        return out.reshape(b, t, h, dh)

    cq = _pick_chunk(t)
    if cq == t:
        pos = torch.arange(t, device=dev)
        mask = pos[:, None] >= pos[None, :]
        if spec.attn in (ATTN_SLIDING, ATTN_CHUNKED) and window:
            if spec.attn == ATTN_SLIDING:
                mask &= pos[None, :] > pos[:, None] - window
            else:  # chunked, non-divisible small case
                mask &= (pos[:, None] // window) == (pos[None, :] // window)
        return sdpa(q, k, v, mask, scale, cfg.attn_softcap)

    nchunks = t // cq
    outs = []
    if spec.attn == ATTN_SLIDING and window:
        # pad keys in front by ceil(window/cq)*cq so each query chunk sees a
        # static band [c0 - band + cq, c0 + cq)
        band = int(np.ceil(window / cq)) * cq + cq
        pad = band - cq
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
        for idx in range(nchunks):
            c0 = idx * cq
            qpos = c0 + torch.arange(cq, device=dev)
            kpos = c0 - pad + torch.arange(band, device=dev)
            mask = ((qpos[:, None] >= kpos[None, :])
                    & (kpos[None, :] > qpos[:, None] - window)
                    & (kpos[None, :] >= 0))
            outs.append(sdpa(q[:, c0:c0 + cq], kp[:, c0:c0 + band],
                             vp[:, c0:c0 + band], mask, scale,
                             cfg.attn_softcap))
        return torch.cat(outs, dim=1)

    kpos = torch.arange(t, device=dev)
    for idx in range(nchunks):
        c0 = idx * cq
        qpos = c0 + torch.arange(cq, device=dev)
        mask = qpos[:, None] >= kpos[None, :]
        outs.append(sdpa(q[:, c0:c0 + cq], k, v, mask, scale,
                         cfg.attn_softcap))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# decode (single token, KV cache; ring buffer for windowed layers)
# ---------------------------------------------------------------------------

def cache_len(spec, max_seq: int) -> int:
    """Ring-buffer length for a layer's cache."""
    if spec.attn in (ATTN_SLIDING, ATTN_CHUNKED) and spec.window:
        return min(spec.window, max_seq)
    return max_seq


def init_attn_cache(cfg, spec, batch: int, max_seq: int, device):
    s = cache_len(spec, max_seq)
    kvd = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(kvd, dtype=dt, device=device),
            "v": torch.zeros(kvd, dtype=dt, device=device)}


def attn_cache_axes(spec):
    """Logical axes of the K/V cache: kv heads over 'model' when they
    divide it, else the head dim (the sharding rules' priority)."""
    return {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


def write_attn_cache(cache, k_new, v_new, pos: int):
    """Write t_new tokens starting at absolute position ``pos`` into the
    ring, in place; returns ``cache``."""
    s = cache["k"].shape[1]
    t_new = k_new.shape[1]
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name]
        if t_new >= s:
            # keep the last s positions, ring-aligned: token at absolute
            # position q lands in slot q mod s
            start = pos + t_new - s  # absolute position of the first kept
            buf.copy_(torch.roll(new[:, -s:], start % s, dims=1))
            continue
        slot = pos % s
        n1 = min(t_new, s - slot)
        buf[:, slot:slot + n1] = new[:, :n1]
        buf[:, :t_new - n1] = new[:, n1:]
    return cache


def ring_positions(s: int, cur_pos: int, device=None):
    """Absolute position held by each ring slot once ``cur_pos`` tokens have
    been written. Slot j holds the largest q < cur_pos with q ≡ j (mod s);
    negative => never written."""
    j = torch.arange(s, device=device)
    last = cur_pos - 1
    return last - torch.remainder(last - j, s)


def attention_decode(cfg, spec, q, cache, cur_pos: int):
    """q: (b, 1, h, dh); cache k/v: (b, s, kv, dh); cur_pos: number of
    tokens already in the cache (the query's absolute position)."""
    s = cache["k"].shape[1]
    scale = 1.0 / np.sqrt(cfg.head_dim)
    kv_pos = ring_positions(s, cur_pos + 1, q.device)  # incl. the new token
    valid = (kv_pos >= 0) & (kv_pos <= cur_pos)
    if spec.attn == ATTN_SLIDING and spec.window:
        valid &= kv_pos > cur_pos - spec.window
    elif spec.attn == ATTN_CHUNKED and spec.window:
        valid &= (kv_pos // spec.window) == (cur_pos // spec.window)
    mask = valid[None, None, :]  # (1, tq=1, s)
    return sdpa(q, cache["k"], cache["v"], mask, scale, cfg.attn_softcap)


# ---------------------------------------------------------------------------
# full layer-level entry points
# ---------------------------------------------------------------------------

def attn_block_prefill(cfg, spec, p, x, positions, prefix: str = "",
                       cache=None, write_pos: int = 0):
    """The attention block's output; writes K/V into ``cache`` (in place)
    when given. positions: (t,) absolute positions."""
    pre = prefix + "/" if prefix else ""
    q, k, v = _qkv(cfg, p, x, positions, spec.use_rope, prefix,
                   theta=spec.rope_theta)
    out = attention_prefill(cfg, spec, q, k, v)
    if cache is not None:
        write_attn_cache(cache, k, v, write_pos)
    b, t = x.shape[:2]
    return out.reshape(b, t, -1) @ p[f"{pre}wo"].to(x.dtype)


def attn_block_decode(cfg, spec, p, x, cur_pos: int, cache,
                      prefix: str = ""):
    """x: (b, 1, d). Writes the new token into the ring (in place), then
    attends; returns the block's output."""
    pre = prefix + "/" if prefix else ""
    positions = torch.full((1,), cur_pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions, spec.use_rope, prefix,
                   theta=spec.rope_theta)
    write_attn_cache(cache, k, v, cur_pos)
    out = attention_decode(cfg, spec, q, cache, cur_pos)
    b = x.shape[0]
    return out.reshape(b, 1, -1) @ p[f"{pre}wo"].to(x.dtype)
