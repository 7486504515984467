"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) (port of
``repro.models.mamba``).

Prefill and training use the chunked SSD dual form: a quadratic,
attention-like product inside fixed-size chunks plus a state recurrence
across chunks. Decode is the O(1) recurrent update.

One departure from the reference: the intra-chunk decay exp(cs_i − cs_j)
is masked to the causal triangle BEFORE the exponential. The reference
takes the exponential of every (i, j) pair and masks after it; for j > i
the exponent is positive, grows with the chunk and overflows to inf, and
inf · 0 is NaN. Where the reference is finite the two agree exactly (the
masked entries are zeros either way), and the masked form has no NaN in
its backward.

Caches are written in place, as the attention caches are: ``conv`` (b,
w−1, conv_dim) in the compute dtype and ``ssm`` (b, h, p, n) in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.params import torch_dtype


def _dims(cfg):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    nheads = d_inner // m.head_dim
    conv_dim = d_inner + 2 * m.ngroups * m.d_state
    return m, d_inner, nheads, conv_dim


def init_mamba(ctx, cfg):
    m, d_inner, nheads, conv_dim = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_inner + 2 * m.ngroups * m.d_state + nheads
    ctx.param("in_proj", (d, proj_out), ("embed", "mlp"))
    ctx.param("conv_w", (m.conv_width, conv_dim), (None, "mlp"), scale=0.5)
    ctx.param("conv_b", (conv_dim,), ("mlp",), init="zeros")
    ctx.param("A_log", (nheads,), (None,), init="a_log")
    ctx.param("D", (nheads,), (None,), init="ones")
    ctx.param("dt_bias", (nheads,), (None,), init="uniform_dt")
    ctx.param("norm/scale", (d_inner,), ("mlp",), init="zeros")
    ctx.param("out_proj", (d_inner, d), ("mlp", "embed"))


def _split_proj(cfg, zxbcdt):
    m, d_inner, nheads, _ = _dims(cfg)
    gs = m.ngroups * m.d_state
    z = zxbcdt[..., :d_inner]
    xs = zxbcdt[..., d_inner:2 * d_inner]
    B = zxbcdt[..., 2 * d_inner:2 * d_inner + gs]
    C = zxbcdt[..., 2 * d_inner + gs:2 * d_inner + 2 * gs]
    dt = zxbcdt[..., 2 * d_inner + 2 * gs:]
    return z, xs, B, C, dt


def _conv_causal(cfg, p, u, pre, conv_state=None):
    """Depthwise causal conv over (b, t, conv_dim). conv_state: (b, w-1, cd)
    holds the trailing inputs of the previous segment (decode). Returns
    (out, the new state)."""
    w = cfg.mamba.conv_width
    t = u.shape[1]
    if conv_state is None:
        up = F.pad(u, (0, 0, w - 1, 0))
    else:
        up = torch.cat([conv_state.to(u.dtype), u], dim=1)
    cw = p[f"{pre}conv_w"].to(u.dtype)
    out = up[:, 0:t] * cw[0]
    for i in range(1, w):
        out = out + up[:, i:i + t] * cw[i]
    out = F.silu(out + p[f"{pre}conv_b"].to(u.dtype))
    new_state = up[:, up.shape[1] - (w - 1):]
    return out, new_state


def _ssd_chunked(xh, dt, A, B, C, chunk: int, init_state=None):
    """SSD dual form.

    xh: (b, t, h, p); dt: (b, t, h) (post-softplus); A: (h,) negative;
    B, C: (b, t, g, n) with g dividing h. Returns (y (b, t, h, p) in xh's
    dtype, the final state (b, h, p, n) fp32)."""
    b, t, h, pdim = xh.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    B = torch.repeat_interleave(B, rep, dim=2)               # (b, t, h, n)
    C = torch.repeat_interleave(C, rep, dim=2)
    L = min(chunk, t)
    pad = (-t) % L
    dtype = xh.dtype
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    tt = t + pad
    nc = tt // L
    f32 = torch.float32
    xh_, dt_, B_, C_ = (a.reshape(b, nc, L, *a.shape[2:]).to(f32)
                        for a in (xh, dt, B, C))
    da = dt_ * A.to(f32)[None, None, None, :]                 # (b, c, l, h)
    cs = torch.cumsum(da, dim=2)                               # decay so far
    seg = cs[:, :, -1:, :]                                     # chunk total

    # intra-chunk (quadratic in L): scores[i,j] = C_i.B_j exp(cs_i - cs_j)
    # dt_j on i >= j; the exponent masked to -inf above the diagonal before
    # the exponential
    idx = torch.arange(L, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    expo = cs[:, :, :, None, :] - cs[:, :, None, :, :]        # (b,c,i,j,h)
    decay = torch.exp(torch.where(causal, expo, float("-inf")))
    del expo
    cb = torch.einsum("bcihn,bcjhn->bcijh", C_, B_)
    scores = cb * decay * dt_[:, :, None, :, :]
    del cb, decay
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xh_)
    del scores

    # per-chunk terminal state: sum_j exp(seg - cs_j) dt_j B_j x_j
    sdec = torch.exp(seg - cs)                                 # (b, c, l, h)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          B_ * (sdec * dt_)[..., None], xh_)   # (b,c,h,p,n)

    # inter-chunk recurrence over c: the state BEFORE each chunk
    segc = torch.exp(seg[:, :, 0, :])                          # (b, c, h)
    st = (torch.zeros((b, h, pdim, n), dtype=f32, device=xh.device)
          if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * segc[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (b,c,h,p,n)

    y = y + torch.einsum("bclhn,bchpn->bclhp", C_,
                         prev_states) * torch.exp(cs)[..., None]
    y = y.reshape(b, tt, h, pdim)[:, :t]
    return y.to(dtype), st


def mamba_prefill(cfg, p, x, prefix: str = "", cache=None):
    """x: (b, t, d) -> the block's output. With ``cache`` (``conv``,
    ``ssm``), the scan starts from ``cache["ssm"]`` and both are written in
    place."""
    pre = prefix + "/" if prefix else ""
    m, d_inner, nheads, conv_dim = _dims(cfg)
    b, t, _ = x.shape
    gs = m.ngroups * m.d_state
    zxbcdt = x @ p[f"{pre}in_proj"].to(x.dtype)
    z, xs, B, C, dt = _split_proj(cfg, zxbcdt)
    u = torch.cat([xs, B, C], dim=-1)
    u, conv_state = _conv_causal(cfg, p, u, pre)
    xs = u[..., :d_inner]
    B = u[..., d_inner:d_inner + gs]
    C = u[..., d_inner + gs:]
    dt = F.softplus(dt.to(torch.float32)
                    + p[f"{pre}dt_bias"].to(torch.float32))
    A = -torch.exp(p[f"{pre}A_log"].to(torch.float32))
    xh = xs.reshape(b, t, nheads, m.head_dim)
    Bg = B.reshape(b, t, m.ngroups, m.d_state)
    Cg = C.reshape(b, t, m.ngroups, m.d_state)
    init_state = cache["ssm"] if cache is not None else None
    y, state = _ssd_chunked(xh, dt, A, Bg, Cg, m.chunk, init_state)
    y = y + xh.to(torch.float32).to(y.dtype) \
        * p[f"{pre}D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, t, d_inner)
    y = rms_norm(y * F.silu(z), p[f"{pre}norm/scale"])
    out = y @ p[f"{pre}out_proj"].to(x.dtype)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(state)
    return out


def init_mamba_cache(cfg, batch: int, device):
    m, d_inner, nheads, conv_dim = _dims(cfg)
    return {"conv": torch.zeros((batch, m.conv_width - 1, conv_dim),
                                dtype=torch_dtype(cfg.dtype), device=device),
            "ssm": torch.zeros((batch, nheads, m.head_dim, m.d_state),
                               dtype=torch.float32, device=device)}


def mamba_cache_axes():
    return {"conv": ("batch", None, "mlp"),
            "ssm": ("batch", None, None, None)}


def mamba_decode(cfg, p, x, cache, prefix: str = ""):
    """Single-token recurrent step. x: (b, 1, d). Writes the cache in
    place; returns the block's output."""
    pre = prefix + "/" if prefix else ""
    m, d_inner, nheads, conv_dim = _dims(cfg)
    b = x.shape[0]
    gs = m.ngroups * m.d_state
    f32 = torch.float32
    zxbcdt = x @ p[f"{pre}in_proj"].to(x.dtype)
    z, xs, B, C, dt = _split_proj(cfg, zxbcdt)
    u = torch.cat([xs, B, C], dim=-1)                          # (b, 1, cd)
    u, conv_state = _conv_causal(cfg, p, u, pre, cache["conv"])
    xs = u[..., :d_inner]
    B = u[..., d_inner:d_inner + gs]
    C = u[..., d_inner + gs:]
    dt = F.softplus(dt.to(f32) + p[f"{pre}dt_bias"].to(f32))    # (b, 1, h)
    A = -torch.exp(p[f"{pre}A_log"].to(f32))
    rep = nheads // m.ngroups
    xh = xs.reshape(b, nheads, m.head_dim).to(f32)
    Bg = torch.repeat_interleave(B.reshape(b, m.ngroups, m.d_state), rep,
                                 dim=1).to(f32)
    Cg = torch.repeat_interleave(C.reshape(b, m.ngroups, m.d_state), rep,
                                 dim=1).to(f32)
    dt1 = dt[:, 0]                                             # (b, h)
    da = torch.exp(dt1 * A[None, :])                           # (b, h)
    state = cache["ssm"].to(f32)
    state = (state * da[:, :, None, None]
             + (dt1[:, :, None] * xh)[..., None] * Bg[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Cg) \
        + xh * p[f"{pre}D"].to(f32)[None, :, None]
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p[f"{pre}norm/scale"])
    out = y @ p[f"{pre}out_proj"].to(x.dtype)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(state)
    return out
