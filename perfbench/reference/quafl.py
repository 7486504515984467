"""QuAFL (paper Algorithm 1) in plain PyTorch: the benchmark's reference
of the program's round, written from the algorithm and independent of the
program's code.

The state is flat fp32 vectors: the server X_t and every client's X^i. A
round polls s clients uniformly without replacement, draws each one's lazy
H_i = min(K, Poisson(lambda_i * elapsed_i)), replays K local SGD steps of
which the first H_i move the model, and exchanges the models through the
rotated-space lattice code (b bits a coordinate up and down): every
message of the round shares one randomized Hadamard rotation, the s uplink
codes are decoded against the server, the one downlink code against each
client, and the (s+1)-averaging runs in rotated coordinates.

The round's randomness is drawn from a ``torch.Generator`` in a fixed
order: the cohort, the H_i, the (s, K, B) minibatch rows, the sign
diagonal, the downlink's rounding noise, the uplink's. Given the seed of
that generator the round is a function of its inputs, so the program's
round can be held to it value for value.

The exchange runs over chunks of whole Hadamard blocks, so that a model of
a billion coordinates fits beside its state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from perfbench import counts

DENSE_SAMPLE_MAX = 4096
FAULTS = (None, "half_batch", "no_exchange", "answer_altered")


@dataclass(frozen=True)
class Federation:
    n: int
    s: int
    K: int
    lr: float
    batch: int
    bits: int = 8
    swt: float = 10.0
    sit: float = 1.0
    lam_fast: float = 0.5
    lam_slow: float = 0.125
    slow_frac: float = 0.3
    safety: float = 8.0


def speeds(fed: Federation) -> np.ndarray:
    """lambda per client: the first round(slow_frac * n) clients are
    slow."""
    lam = np.full(fed.n, fed.lam_fast, dtype=np.float32)
    lam[:int(round(fed.slow_frac * fed.n))] = fed.lam_slow
    return lam


class State:
    """The server, every client's row, their last contact times, the
    simulated clock, the running estimate of the server-client distance
    and the bits sent."""

    def __init__(self, x0: torch.Tensor, fed: Federation):
        dev = x0.device
        self.server = x0.clone()
        self.clients = x0[None].repeat(fed.n, 1)
        self.last_time = torch.zeros(fed.n, dtype=torch.float32, device=dev)
        self.lam = torch.as_tensor(speeds(fed), device=dev)
        self.sim_time = 0.0
        self.srv_dist_est = torch.tensor(1e-3, device=dev)
        self.bits_up = 0
        self.bits_down = 0


# ---------------------------------------------------------------------------
# the randomized Hadamard rotation and the lattice code
# ---------------------------------------------------------------------------

def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unscaled Sylvester transform along the last axis (a power of two),
    in radix-2 stages h = 1, 2, 4, ..."""
    shape = x.shape
    b = shape[-1]
    rows = x.numel() // b
    h = 1
    while h < b:
        v = x.reshape(rows, b // (2 * h), 2, h)
        x = torch.stack((v[:, :, 0] + v[:, :, 1], v[:, :, 0] - v[:, :, 1]),
                        dim=2)
        h *= 2
    return x.reshape(shape)


def rotate(x: torch.Tensor, sg: torch.Tensor, b: int,
           inverse: bool = False) -> torch.Tensor:
    """(m, C) rows of whole b-blocks: signs then H_b / sqrt(b) per block,
    or the inverse (H_b / sqrt(b), then signs)."""
    scale = float(np.float32(1.0 / math.sqrt(b)))
    if not inverse:
        x = x * sg
    y = fwht(x.reshape(-1, b)).reshape(x.shape) * scale
    return y * sg if inverse else y


def coord_bound(norms: torch.Tensor, d_pad: int) -> torch.Tensor:
    """High-probability bound on the largest rotated coordinate of a
    vector of the given norm."""
    return (norms.to(torch.float32) / float(np.sqrt(d_pad))
            * float(np.sqrt(2 * np.log(2 * d_pad + 1)) + 2.0))


def gammas(hints: torch.Tensor, xnorms: torch.Tensor, d: int, bits: int,
           safety: float) -> torch.Tensor:
    """The lattice step of each message: its wrap window 2^b gamma holds
    twice the largest rotated coordinate of the distance hint, and gamma
    stays above 2^-18 of the message's own largest coordinate (fp32 keeps
    sub-integer precision of y / gamma)."""
    d_pad = counts.pad_len(d)
    base = torch.clamp(safety * 2.0 * coord_bound(hints, d_pad)
                       / float(1 << bits), min=1e-12)
    return torch.maximum(base, coord_bound(xnorms, d_pad) * 2.0 ** -18)


def quantize(y: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
             levels: float) -> torch.Tensor:
    """floor(y / gamma + u) mod L, as fp32 integers."""
    q = torch.floor(y / g[:, None] + u)
    return q - levels * torch.floor(q / levels)


def snap(codes: torch.Tensor, ref: torch.Tensor, g: torch.Tensor,
         levels: float) -> torch.Tensor:
    """The lattice point congruent to the code nearest the reference,
    gamma (c + L round((ref / gamma - c) / L))."""
    g = g[:, None]
    return (codes + levels * torch.round((ref / g - codes) / levels)) * g


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def _padded(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    if x.shape[-1] == d_pad:
        return x
    return torch.nn.functional.pad(x, (0, d_pad - x.shape[-1]))


def exchange(server, Y, hints, gen, fed: Federation, fault=None,
             chunk_blocks: int = 1024):
    """The round's lattice exchange and (s+1)-averaging. Returns
    (server_new (d,), clients_new (s, d), hint_srv). Consumes ``Y``."""
    s, d = Y.shape
    d_pad = counts.pad_len(d)
    b = counts.block_size(d)
    levels = float(1 << fed.bits)
    dev = Y.device
    sg_bits = torch.randint(0, 2, (d_pad,), generator=gen, device=dev,
                            dtype=torch.int8)
    u_srv = torch.rand((1, d_pad), generator=gen, device=dev)
    u_cl = torch.rand((s, d_pad), generator=gen, device=dev)
    g_up = gammas(hints, torch.linalg.vector_norm(Y, dim=1), d, fed.bits,
                  fed.safety)
    Yp = _padded(Y, d_pad)
    del Y
    srv = _padded(server[None], d_pad)
    server_new = torch.empty(d_pad, dtype=torch.float32, device=dev)
    sq = torch.zeros(s, dtype=torch.float64, device=dev)
    C = b * chunk_blocks

    def signs(a):
        return sg_bits[a:a + C].to(torch.float32) * 2 - 1

    # uplink: encode each client's rotated model, decode against the server
    for a in range(0, d_pad, C):
        sgc = signs(a)
        y_rot = rotate(Yp[:, a:a + C], sgc, b)
        s_rot = rotate(srv[:, a:a + C], sgc, b)
        qy = snap(quantize(y_rot, u_cl[:, a:a + C], g_up, levels), s_rot,
                  g_up, levels)
        sq += torch.sum(torch.square(qy - s_rot), dim=1, dtype=torch.float64)
        if fault == "no_exchange":
            new = s_rot[0]
        else:
            new = (s_rot[0] + torch.sum(qy, 0)) / (s + 1)
        server_new[a:a + C] = rotate(new[None], sgc, b, inverse=True)[0]
        Yp[:, a:a + C] = y_rot
    del u_cl
    hint_srv = torch.sqrt(torch.max(sq)).to(torch.float32) + 1e-8
    g_dn = gammas(hint_srv[None], torch.linalg.vector_norm(server)[None], d,
                  fed.bits, fed.safety)
    # downlink: encode the rotated server, decode against each client
    for a in range(0, d_pad, C):
        sgc = signs(a)
        s_rot = rotate(srv[:, a:a + C], sgc, b)
        y_rot = Yp[:, a:a + C]
        if fault == "no_exchange":
            new = y_rot
        else:
            qx = snap(quantize(s_rot, u_srv[:, a:a + C], g_dn, levels),
                      y_rot, g_dn, levels)
            new = qx / (s + 1) + (y_rot * s) / (s + 1)
        Yp[:, a:a + C] = rotate(new, sgc, b, inverse=True)
    if fault == "answer_altered":
        server_new[:b] = 0.0
    return server_new[:d], Yp[:, :d], hint_srv


def sample(gen: torch.Generator, n: int, s: int) -> torch.Tensor:
    """s of n clients, uniform without replacement: the first s of a
    random permutation, or Floyd's algorithm past DENSE_SAMPLE_MAX."""
    dev = gen.device
    if n <= DENSE_SAMPLE_MAX:
        return torch.randperm(n, generator=gen, device=dev)[:s]
    chosen = torch.full((s,), -1, dtype=torch.int64, device=dev)
    for i in range(s):
        j = n - s + i
        t = torch.randint(0, j + 1, (1,), generator=gen, device=dev)
        dup = (chosen[:i] == t).any()
        chosen[i:i + 1] = torch.where(dup, torch.full_like(t, j), t)
    return chosen


def one_round(st: State, fed: Federation, pool: int, gen: torch.Generator,
              progress: Callable, fault: Optional[str] = None) -> State:
    """One server round, in place on ``st``. ``progress(cl, idx, rows,
    active)`` returns h~ (s, d): the sum of each polled client's gradients
    over its active steps (``active`` (s, K) 0/1), the model moving by
    -lr g at each active step, from its row ``cl``."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    s, K = fed.s, fed.K
    dev = st.server.device
    idx = sample(gen, fed.n, s).long()
    sim = torch.tensor(st.sim_time, dtype=torch.float64, device=dev)
    elapsed = sim + fed.swt + fed.sit - st.last_time[idx]
    draws = torch.poisson((st.lam[idx] * elapsed).to(torch.float32),
                          generator=gen)
    h = torch.clamp(draws, max=K).to(torch.int32)
    rows = torch.randint(0, pool, (s, K, fed.batch), generator=gen,
                         device=dev)
    active = (torch.arange(K, device=dev)[None] < h[:, None]).float()
    cl = st.clients[idx]
    prog = progress(cl, idx, rows, active)
    prog.mul_(torch.full((s, 1), fed.lr, dtype=torch.float32, device=dev))
    Y = cl.sub_(prog)
    hints = torch.linalg.vector_norm(prog, dim=1) + st.srv_dist_est + 1e-8
    del prog
    server_new, cl_new, hint_srv = exchange(st.server, Y, hints, gen, fed,
                                            fault)
    new_time = st.sim_time + (fed.swt + fed.sit)
    st.clients[idx] = cl_new
    st.last_time[idx] = new_time
    st.server = server_new
    st.sim_time = new_time
    st.srv_dist_est = 0.5 * st.srv_dist_est + 0.5 * hint_srv
    up, down = counts.round_bits(st.server.shape[0], s, fed.bits)
    st.bits_up += up
    st.bits_down += down
    return st


def local_progress(grad: Callable, cl, idx, rows, active, lr: float):
    """h~ of the polled clients, one client at a time: ``grad(x, i, r)``
    is client ``idx[i]``'s gradient (d,) at ``x`` on its pool rows
    ``r``."""
    h = torch.zeros_like(cl)
    for i in range(cl.shape[0]):
        x = cl[i].clone()
        for q in range(rows.shape[1]):
            g = grad(x, i, rows[i, q]).mul_(active[i, q])
            h[i].add_(g)
            x.add_(g, alpha=-lr)
            del g
    return h
