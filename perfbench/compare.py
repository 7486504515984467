"""The comparison that decides ``correct``: the program's state after the
check rounds against the plain reference's, leaf by leaf.

For each leaf of the flat layout, and for the server and each client row,
with X0 the initial model, P the program's row and R the reference's:

* ``server_gap``  max over leaves of |P - R| / max(|R - X0|, m), m the
  median leaf's |R - X0|: how far the new server lies from the
  reference's, against how far the rounds moved it.
* ``client_gap``  the same over every client row and leaf, m the median
  over the rows the reference moved. A row the reference left at X0 and
  the program moved reads |P - X0| / m.
* ``change_gap``  max over the server's and the moved rows' leaves of
  | |P - X0| - |R - X0| | / max(|R - X0|, m): the gap between the norms of
  the two changes, which does not depend on where the rounding noise of
  each side falls. A leaf whose change in the reference is under a
  thousandth of the median leaf's is left out of it (a leaf that only
  round-off moves).
* ``step1_gap``   ``change_gap`` of the server after the first round
  (where that state is observable: one round a call).
* ``loss1_gap``   max over the first round's local steps (every polled
  client's K steps, in order) of |L_P - L_R| / |L_R|: each step's loss.
* ``grad1_gap``   max over the polled clients and the leaves of
  | |g_P| - |g_R| | / max(|g_R|, m) at each client's first local step,
  m the median leaf's |g_R|: the norm of the first gradient as the
  optimizer gets it, a leaf whose |g_R| is under m / 1000 left out.
* ``grad1_dir_gap`` the same leaves' |g_P - g_R| / max(|g_R|, m) over
  the entries at a sample of indices drawn from the seed (65,536 a leaf):
  the first gradient's direction. It is taken at the initial model from
  the same rows on both sides, before any lattice code, so rounding flips
  do not reach it.

The first round's steps are recorded by :class:`FirstSteps`, which the
program's side fills through a wrapper of its loss and the reference's
directly.
* ``bits_gap``    |bits up - reference's| + |bits down - reference's|
  over the check rounds: the wire's bit count, exact.

Norms are l2, summed in fp64.
"""
from __future__ import annotations

import math

import torch

NUMBERS = ("bits_gap", "server_gap", "client_gap", "change_gap",
           "step1_gap", "loss1_gap", "grad1_gap", "grad1_dir_gap")
SAMPLE = 65536


def _norms(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, dtype=torch.float64)


def _row_norms(prog_rows, ref_rows, x0, leaves, device):
    """(dp, cr, cp), each (rows, leaves): |P - R|, |R - X0|, |P - X0|."""
    dp, cr, cp = [], [], []
    off = 0
    for _, shape, _ in leaves:
        n = math.prod(shape)
        sl = slice(off, off + n)
        P = prog_rows[:, sl].to(device)
        R = ref_rows[:, sl].to(device)
        X = x0[sl][None]
        dp.append(_norms(P - R))
        cr.append(_norms(R - X))
        cp.append(_norms(P - X))
        del P, R
        off += n
    return (torch.stack(dp, 1).cpu(), torch.stack(cr, 1).cpu(),
            torch.stack(cp, 1).cpu())


def state_dict(st) -> dict:
    """A reference state in the form :func:`numbers` compares."""
    return {"server": st.server, "clients": st.clients,
            "first_server": getattr(st, "first_server", None),
            "first_steps": getattr(st, "first_steps", None),
            "bits_up": float(st.bits_up), "bits_down": float(st.bits_down)}


def _change_gaps(cr, cp, med) -> torch.Tensor:
    """| |P - X0| - |R - X0| | / max(|R - X0|, med) of each entry, the
    entries that round-off alone moves (|R - X0| under med / 1000) left
    out."""
    keep = cr >= 1e-3 * med
    return ((cp - cr).abs() / torch.clamp(cr, min=med))[keep]


def _change_gap(cr, cp, med) -> float:
    gaps = _change_gaps(cr, cp, med)
    return float(torch.max(gaps)) if gaps.numel() else float("inf")


class FirstSteps:
    """One side's record of its first round's local steps: each step's
    loss, in the order they run (client by client, step by step), and at
    each client's first step the gradient of every leaf, as its norm and
    its entries at ``sample`` {leaf: indices}. ``K`` steps a client;
    ``on`` is cleared once the first round is over."""

    def __init__(self, sample: dict, K: int):
        self.sample, self.K = sample, K
        self.losses, self.grads = [], []
        self.steps, self.on = 0, True

    def begin(self):
        """At a local step's start: the dict that the step's leaf
        gradients go into at a client's first step, else None."""
        if not self.on:
            return None
        rec = None
        if self.steps % self.K == 0:
            rec = {}
            self.grads.append(rec)
        self.steps += 1
        return rec

    def put(self, rec: dict, name: str, g: torch.Tensor) -> None:
        flat = g.detach().reshape(-1).to(torch.float32)
        rec[name] = (torch.linalg.vector_norm(flat, dtype=torch.float64),
                     flat[self.sample[name]].to(torch.float64))

    def loss(self, value: torch.Tensor) -> None:
        if self.on:
            self.losses.append(value.detach().to(torch.float64).reshape(()))

    def host(self, names) -> dict:
        """``losses`` (steps,), ``norms`` (clients, leaves) and ``picks``
        [(clients, sample) a leaf], on the host; a leaf that got no
        gradient reads zeros."""
        def got(r, k):
            if k in r:
                return r[k]
            z = torch.zeros(len(self.sample[k]), dtype=torch.float64)
            return z.norm(), z

        return {"losses": torch.stack(self.losses).cpu(),
                "norms": torch.stack([torch.stack([got(r, k)[0].cpu()
                                                   for k in names])
                                      for r in self.grads]),
                "picks": [torch.stack([got(r, k)[1].cpu()
                                       for r in self.grads]) for k in names]}


def sample_indices(leaves, seed: int, dev) -> dict:
    """{leaf: SAMPLE indices into it} (all of a smaller leaf), drawn from
    ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, shape, _ in leaves:
        n = math.prod(shape)
        out[name] = (torch.arange(n, device=dev) if n <= SAMPLE else
                     torch.randint(0, n, (SAMPLE,), generator=gen,
                                   device=dev))
    return out


def first_step_gaps(P: dict, R: dict) -> dict:
    """``loss1_gap``, ``grad1_gap``, ``grad1_dir_gap`` of two
    :meth:`FirstSteps.host` records; a record of another length fails."""
    if (P["losses"].shape != R["losses"].shape
            or P["norms"].shape != R["norms"].shape):
        inf = float("inf")
        return {"loss1_gap": inf, "grad1_gap": inf, "grad1_dir_gap": inf}
    loss1 = float(torch.max((P["losses"] - R["losses"]).abs()
                            / R["losses"].abs()))
    nr = R["norms"]
    med = float(torch.median(nr))
    keep = nr >= 1e-3 * med
    gaps = ((P["norms"] - nr).abs() / torch.clamp(nr, min=med))[keep]
    dn = torch.stack([torch.linalg.vector_norm(p - r, dim=1)
                      for p, r in zip(P["picks"], R["picks"])], 1)
    rn = torch.stack([torch.linalg.vector_norm(r, dim=1)
                      for r in R["picks"]], 1)
    rmed = float(torch.median(rn))
    dirs = (dn / torch.clamp(rn, min=rmed))[keep]
    return {"loss1_gap": loss1,
            "grad1_gap": float(torch.max(gaps)) if gaps.numel() else 0.0,
            "grad1_dir_gap": float(torch.max(dirs)) if dirs.numel()
            else 0.0,
            "grad1_leaves": (dn / torch.clamp(rn, min=rmed)).tolist()}


def numbers(prog: dict, ref: dict, x0: torch.Tensor, leaves) -> dict:
    """The compared numbers of the program's state ``prog`` against the
    reference's ``ref``: each a dict of ``server`` (d,) and ``clients``
    (n, d), on any device, the cumulative ``bits_up`` and ``bits_down``,
    and, where both hold them, ``first_server`` after the first round and
    ``first_steps``, a :meth:`FirstSteps.host` record. Norms are taken on
    ``x0``'s device."""
    dev = x0.device
    s_dp, s_cr, s_cp = _row_norms(prog["server"][None], ref["server"][None],
                                  x0, leaves, dev)
    c_dp, c_cr, c_cp = _row_norms(prog["clients"], ref["clients"], x0,
                                  leaves, dev)
    s_med = float(torch.median(s_cr[0]))
    server_gap = float(torch.max(s_dp / torch.clamp(s_cr, min=s_med)))
    moved = c_cr.sum(1) > 0
    c_med = (float(torch.median(c_cr[moved])) if bool(moved.any())
             else s_med)
    client_gap = float(torch.max(c_dp / torch.clamp(c_cr, min=c_med)))
    change_gap = max(_change_gap(s_cr, s_cp, s_med),
                     _change_gap(c_cr[moved], c_cp[moved], c_med))
    out = {"step1_gap": None, "loss1_gap": None, "grad1_gap": None,
           "grad1_dir_gap": None}
    leaf = {"server": (s_dp / torch.clamp(s_cr, min=s_med))[0].tolist(),
            "server_change": s_cr[0].tolist(),
            "server_prog_change": s_cp[0].tolist(),
            "clients_change": c_cr[:8].tolist(),
            "clients_prog_change": c_cp[:8].tolist(),
            "step1": [], "grad1": []}
    if prog.get("first_server") is not None and \
            ref.get("first_server") is not None:
        _, f_cr, f_cp = _row_norms(prog["first_server"][None],
                                   ref["first_server"][None], x0, leaves,
                                   dev)
        gaps = _change_gaps(f_cr, f_cp, float(torch.median(f_cr[0])))
        leaf["step1"] = gaps.tolist()
        out["step1_gap"] = (float(torch.max(gaps)) if gaps.numel()
                            else float("inf"))
    if prog.get("first_steps") is not None and \
            ref.get("first_steps") is not None:
        out.update(first_step_gaps(prog["first_steps"], ref["first_steps"]))
        leaf["grad1"] = out.pop("grad1_leaves")
    bits_gap = (abs(prog["bits_up"] - ref["bits_up"])
                + abs(prog["bits_down"] - ref["bits_down"]))
    return {"bits_gap": float(bits_gap), "server_gap": server_gap,
            "client_gap": client_gap, "change_gap": change_gap, **out,
            "leaf_gaps": leaf}


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every compared number at or
    under its limit; a number that is not finite fails. A number whose
    limit is null is not compared in that cell."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS
              if limits.get(k) is not None}
    ok = all(c["value"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
