"""Beyond-paper extensions the paper's §5 names as future work (port of
``repro.core.extensions``).

1. **QuAFL-SCAFFOLD**: controlled averaging [Karimireddy et al.] on top of
   Algorithm 1. Every client keeps a control variate c_i and the server
   keeps c; local steps use g − c_i + c, and the sampled clients' control
   updates ride the same quantized exchange (the lattice quantizer is
   position-aware with respect to the previous control, so the extra
   message costs the same b bits a coordinate). It removes the client
   drift under non-iid data that dominates QuAFL's heterogeneous bound.

2. **Adaptive bit-width** (cf. AdaQuantFL, which the paper cites as
   iid-only): the server tracks the measured relative quantization error
   of the decoded client messages and walks b up or down between rounds
   to keep it inside a band.

Both implement :class:`repro_torch.fed.FedAlgorithm` (registry names
``"quafl_scaffold"`` and ``"adaptive_quafl"``), so they run through
``simulate`` and ``compare`` like every paper algorithm. The legacy
``AdaptiveQuAFL`` wrapper (state held inside, ``round(data, generator)``)
is a thin shim over the protocol class.

Both take QuAFL's ``batch_fn`` (the per-client protocol, any model) and
pass it on. ``QuaflScaffold.round(state, data, generator, draws=None)``
takes QuAFL's draws (``idx``, ``part_noise``, ``h_steps``, ``batch_idx``) and three
message keys: ``key_up`` (the s model messages), ``key_ctl`` (the s
control messages) and ``key_dn`` (the one downlink broadcast).

Both take QuAFL's ``client_mesh``: SCAFFOLD's ``control`` row is split with
the model rows (gathered and scattered with them), and each width of the
adaptive walk is a QuAFL on the same mesh, all sharing one split store.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.quafl import QuAFL, QuaflState
from repro_torch.fed.population import (client_rows, scatter_rows,
                                        shard_population, whole_row,
                                        with_rows)


def _norms(x2):
    return torch.linalg.vector_norm(x2, dim=1)


class ScaffoldState(NamedTuple):
    base: QuaflState
    c_server: torch.Tensor     # server control variate (d,)

    @property
    def c_clients(self):
        """Per-client control variates (n, d), a row of the base state's
        store (gathered and scattered with the model rows; all-gathered
        when the store is split)."""
        return whole_row(self.base.pop.rows["control"])

    @property
    def bits_sent(self):
        return self.base.bits_sent


@dataclass(eq=False)
class QuaflScaffold(QuAFL):
    """QuAFL with SCAFFOLD control variates (option-II updates).

    Model and control messages both ride the ``uplink`` codec, the downlink
    broadcast the ``downlink`` codec, message by message through the codec
    API: per round one encode of the s models (decoded against X_t), one of
    the s controls (each decoded against that client's previous c_i) and
    one of X_t (decoded against each sampled client's model). A stateful
    codec runs its stateless encode: the control stream has no
    error-feedback slot to thread.

    The bits charge 2 messages up per sampled client and 2 down, as the
    reference does, although only one downlink message (Enc(X_t)) is ever
    encoded: the server control is charged as broadcast."""

    def init(self, params0) -> ScaffoldState:
        base = super().init(params0)
        z = torch.zeros_like(base.server)
        # the control variates are one more per-client row of the store,
        # split with the others under client_mesh
        base = base._replace(pop=shard_population(with_rows(
            base.pop, control=client_rows(z, self.fed.n_clients)),
            self.client_mesh))
        return ScaffoldState(base=base, c_server=z)

    def round(self, state: ScaffoldState, data, generator: torch.Generator,
              draws: Dict[str, torch.Tensor] = None):
        fed = self.fed
        n, s, d = fed.n_clients, fed.s, self.d
        base = state.base
        draws = {k: v.to(self.device) for k, v in (draws or {}).items()}

        def draw(name, fn):
            return draws[name] if name in draws else fn()

        idx, got, h_steps, bidx = self._cohort(base, data, generator,
                                               draws)
        cl, c_i = got["model"], got["control"]
        c_srv = state.c_server[None, :]
        h_tilde = self._local_progress(cl, data, idx, bidx, h_steps,
                                       correction=c_i - c_srv)
        prog = fed.lr * self._eta_t[idx][:, None] * h_tilde
        Y = cl - prog

        # control update (option II): c_i+ = c_i − c + h̃/H_i
        steps = torch.clamp(h_steps.to(torch.float32), min=1.0)[:, None]
        c_new = c_i - c_srv + h_tilde / steps

        # the quantized exchange: model messages against X_t, control
        # messages against each client's PREVIOUS control
        up = self.codec_up
        key_up = draw("key_up", lambda: up.keys(generator, s, d))
        key_ctl = draw("key_ctl", lambda: up.keys(generator, s, d))
        hints = _norms(prog) + base.srv_dist_est
        QY = up.decode(key_up, up.encode(key_up, Y, hints + 1e-8),
                       base.server[None])
        QC = up.decode(key_ctl, up.encode(key_ctl, c_new,
                                          _norms(c_new - c_i) + 1e-8), c_i)

        server_new = (base.server + torch.sum(QY, 0)) / (s + 1)
        c_server_new = state.c_server + torch.sum(QC - c_i, 0) / n

        dn = self.codec_down
        key_dn = draw("key_dn", lambda: dn.keys(generator, 1, d))
        hint_srv = torch.max(_norms(QY - base.server[None])) + 1e-8
        msg = dn.encode(key_dn, base.server[None], hint_srv[None])
        # a codec that ignores the reference decodes one row for all
        QX = dn.decode(key_dn, msg, cl).expand(s, d)
        cl_new = QX / (s + 1) + s * Y / (s + 1)

        # 2 messages up per sampled client (model + control), 2 down (the
        # broadcast Enc(X_t) + the control broadcast)
        bits_up = 2 * s * up.message_bits(d)
        bits_down = 2 * dn.message_bits(d)
        dt = fed.swt + fed.sit
        new_time = base.sim_time + dt
        # one scatter covers models, interaction times and controls; the
        # codec_up row passes through untouched (stateless encodes)
        nbase = QuaflState(
            server=server_new,
            pop=scatter_rows(base.pop, idx, {"model": cl_new,
                                             "last_time": new_time,
                                             "control": QC}),
            t=base.t + 1, sim_time=new_time,
            bits_up=base.bits_up + bits_up,
            bits_down=base.bits_down + bits_down,
            srv_dist_est=0.5 * base.srv_dist_est + 0.5 * hint_srv)
        rel_err = torch.mean(_norms(QY - Y) / (_norms(Y) + 1e-9))
        hs = h_steps.to(torch.float32)
        metrics = {"sim_time": new_time,
                   "round_time": dt,
                   "bits_up": float(bits_up),
                   "bits_down": float(bits_down),
                   "h_steps_mean": hs.mean(),
                   "h_zero_frac": (hs == 0).to(torch.float32).mean(),
                   "quant_err": rel_err,
                   "c_norm": torch.linalg.vector_norm(c_server_new)}
        return ScaffoldState(base=nbase, c_server=c_server_new), metrics

    def eval_params(self, state: ScaffoldState):
        return super().eval_params(state.base)


# ---------------------------------------------------------------------------
# adaptive bit-width controller
# ---------------------------------------------------------------------------

@dataclass
class AdaptiveBits:
    """Walks the bit-width to keep the measured relative quantization error
    inside [lo, hi]. The bits are part of the round's shared parameters
    (the server announces b with the poll), so adapting them is free."""
    bits: int = 8
    lo: float = 0.01
    hi: float = 0.05
    b_min: int = 4
    b_max: int = 16

    @staticmethod
    def walk(bits: int, rel_err: float, lo: float, hi: float,
             b_min: int, b_max: int) -> int:
        """One controller step, the stateless core the protocol class
        shares; the result stays in [b_min, b_max] for inputs in range."""
        if rel_err > hi and bits < b_max:
            return bits + 1
        if rel_err < lo and bits > b_min:
            return bits - 1
        return bits

    def update(self, rel_err: float) -> int:
        self.bits = self.walk(self.bits, rel_err, self.lo, self.hi,
                              self.b_min, self.b_max)
        return self.bits


_TRACE_CAP = 4096   # bounds the per-round tuple copy; the full history is
                    # in the "bits_width" metric every round emits


@dataclass
class AdaptiveState:
    """The wrapped QuAFL state, the python-int bit-width (it selects the
    QuAFL instance) and the trace of visited widths (a tuple, so forked
    states stay independent; capped at the last ``_TRACE_CAP``)."""
    inner: QuaflState
    bits: int
    trace: Tuple[int, ...] = ()

    @property
    def sim_time(self):
        return self.inner.sim_time

    @property
    def bits_sent(self):
        return self.inner.bits_sent


class AdaptiveQuaflAlgorithm:
    """Adaptive bit-width QuAFL as a :class:`repro_torch.fed.FedAlgorithm`.

    Composition over a QuAFL factory: one QuAFL instance per visited
    bit-width (at most b_max − b_min + 1), all sharing one state. Eagerly,
    the walk reacts to the measured ``quant_err`` of the round just run,
    read on the host every round; in chunks (:meth:`scan_rounds`) to the
    chunk's last one."""

    def __init__(self, fed: FedConfig, make_alg, *, lo: float = 0.01,
                 hi: float = 0.05, b_min: int = 4, b_max: int = 16):
        self.fed = fed
        self.make_alg = make_alg
        self.lo, self.hi, self.b_min, self.b_max = lo, hi, b_min, b_max
        self._algs = {}
        self._engines = {}   # bits -> RoundEngine over that width's QuAFL

    def _alg(self, bits: int):
        if bits not in self._algs:
            self._algs[bits] = self.make_alg(
                dataclasses.replace(self.fed, bits=bits))
        return self._algs[bits]

    def init(self, params0) -> AdaptiveState:
        return AdaptiveState(inner=self._alg(self.fed.bits).init(params0),
                             bits=self.fed.bits)

    def round(self, state: AdaptiveState, data, generator: torch.Generator,
              draws: Dict[str, torch.Tensor] = None):
        """One QuAFL round at the state's width (``draws`` as QuAFL's),
        then one step of the walk."""
        inner, m = self._alg(state.bits).round(state.inner, data, generator,
                                               draws=draws)
        rel = float(m["quant_err"]) if "quant_err" in m else 0.02
        new_bits = AdaptiveBits.walk(state.bits, rel, self.lo, self.hi,
                                     self.b_min, self.b_max)
        metrics = {**m, "bits_width": float(state.bits)}
        return AdaptiveState(
            inner=inner, bits=new_bits,
            trace=(state.trace + (state.bits,))[-_TRACE_CAP:]), metrics

    def scan_rounds(self, state: AdaptiveState, data, generator,
                    length: int):
        """``length`` rounds through the round engine of the state's
        width. The width selects the QuAFL instance, so it stays fixed
        inside a chunk, and the walk moves once per chunk, on the chunk's
        last ``quant_err``: that read is the chunk-boundary host sync.
        ``length=1`` is the eager walk exactly."""
        from repro_torch.fed.engine import RoundEngine
        eng = self._engines.get(state.bits)
        if eng is None:
            eng = self._engines[state.bits] = RoundEngine(
                self._alg(state.bits))
        inner, ms = eng.run_chunk(state.inner, data, generator, length)
        rel = float(ms["quant_err"][-1])   # the chunk-boundary host sync
        new_bits = AdaptiveBits.walk(state.bits, rel, self.lo, self.hi,
                                     self.b_min, self.b_max)
        ms = {**ms, "bits_width": float(state.bits)}
        return AdaptiveState(
            inner=inner, bits=new_bits,
            trace=(state.trace + (state.bits,) * length)[-_TRACE_CAP:]), ms

    def eval_params(self, state: AdaptiveState):
        return self._alg(state.bits).eval_params(state.inner)


class AdaptiveQuAFL:
    """Legacy wrapper (state held inside): a thin shim over
    :class:`AdaptiveQuaflAlgorithm` keeping the original interface."""

    def __init__(self, fed: FedConfig, make_alg, params0):
        self.fed = fed
        self.make_alg = make_alg
        self.params0 = params0
        self._impl = AdaptiveQuaflAlgorithm(fed, make_alg)
        self.state = self._impl.init(params0)

    @property
    def bits_trace(self):
        return list(self.state.trace)

    def round(self, data, generator):
        self.state, m = self._impl.round(self.state, data, generator)
        return m

    def eval_params(self):
        return self._impl.eval_params(self.state)
