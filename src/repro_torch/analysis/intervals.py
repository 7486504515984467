"""γ-overflow interval analysis of the encode path (port of
``repro.analysis.intervals``).

Lemma 3.1's wrap condition is the exchange's numerical contract: a snapped
code recovers the right lattice point only while the decode reference
stays within half a wrap window (``levels·γ/2``) of the encoded vector.
The γ derivation (``wrap_gamma`` and the fp32 floor in
``ExchangePipeline.gammas``) is meant to guarantee it; these checks prove
it on the port's own code, with intervals.

:func:`interval_of` takes the aten graph of a function from
``torch.fx.experimental.proxy_tensor.make_fx`` on example tensors and
pushes one (lo, hi) interval a value through it, node by node, with a
transfer table (add/sub/mul/div, clamp, abs, sqrt, rsqrt, log, exp, sign,
pow, remainder, sum, ``where``, conversions, the views). The margin
functions are straight-line code, so one pass in graph order is the whole
analysis: the reference's worklist engine (``analysis/flow.py``) has no
loop to iterate here and is not ported. The floored modulo the plain
quantize spells ``q - L·floor(q / L)`` is summarised as [0, L], the
port's counterpart of the reference's ``remainder`` call override.

* :func:`check_encode_intervals` — the quantize path (before packing)
  cannot emit codes past the codec's declared moduli;
* :func:`check_gamma_window` — the wrap margin ``L/2 − (coord_bound(dist)
  / γ + 1)`` through the pipeline's ``gammas`` over hint bands ``[h, 2h]``
  from 2^-20 to 2^20, the distance bounded by the band's hint (hints
  upper-bound ‖Y − X‖): a positive lower bound on every band proves no
  wrap at any scale (with band ratio 2 the obligation is ``L/2 − L/safety
  − 1 > 0``);
* :func:`check_rs_gamma_window` — the same through
  ``core/exchange_local.rs_gamma`` on the summed bands ``[n·h, 2n·h]``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.analysis.violation import Violation

Interval = Tuple[float, float]

TOP: Interval = (-math.inf, math.inf)

# hint ladder: powers of two, each analysed as the band [h, 2h] so
# consecutive bands tile every positive hint scale
LADDER_LO, LADDER_HI = -20, 20


def _iv(lo: float, hi: float) -> Interval:
    return (float(lo), float(hi))


def _mul_iv(a: Interval, b: Interval) -> Interval:
    def prod(x, y):
        if x == 0.0 or y == 0.0:  # avoid 0 * inf -> nan
            return 0.0
        return x * y
    ps = [prod(a[0], b[0]), prod(a[0], b[1]), prod(a[1], b[0]),
          prod(a[1], b[1])]
    return _iv(min(ps), max(ps))


def _div_iv(a: Interval, b: Interval) -> Interval:
    if b[0] <= 0.0 <= b[1]:
        return TOP

    def quot(x, y):
        q = x / y if not (math.isinf(x) and math.isinf(y)) else 0.0
        return 0.0 if math.isnan(q) else q
    qs = [quot(a[0], b[0]), quot(a[0], b[1]), quot(a[1], b[0]),
          quot(a[1], b[1])]
    return _iv(min(qs), max(qs))


def _join(*ivs: Interval) -> Interval:
    return _iv(min(v[0] for v in ivs), max(v[1] for v in ivs))


def _int_ends(f, a: Interval) -> Interval:
    """``f`` (floor, ceil, round) of each finite end."""
    return _iv(*(f(x) if math.isfinite(x) else x for x in a))


def _abs_iv(a: Interval) -> Interval:
    if a[0] <= 0.0 <= a[1]:
        return _iv(0.0, max(-a[0], a[1]))
    lo, hi = abs(a[0]), abs(a[1])
    return _iv(min(lo, hi), max(lo, hi))


def _sqrt_iv(a: Interval) -> Interval:
    return _iv(math.sqrt(max(a[0], 0.0)),
               math.sqrt(a[1]) if a[1] >= 0.0 else 0.0)


def _rsqrt_iv(a: Interval) -> Interval:
    if a[0] <= 0.0:
        return TOP
    return _iv(1.0 / math.sqrt(a[1]), 1.0 / math.sqrt(a[0]))


def _log_iv(a: Interval) -> Interval:
    return _iv(math.log(a[0]) if a[0] > 0.0 else -math.inf,
               math.log(a[1]) if a[1] > 0.0 else -math.inf)


def _exp_iv(a: Interval) -> Interval:
    return _iv(math.exp(min(a[0], 700.0)), math.exp(min(a[1], 700.0)))


def _sign_iv(a: Interval) -> Interval:
    return _iv(-1.0 if a[0] < 0.0 else 0.0 if a[0] == 0.0 else 1.0,
               1.0 if a[1] > 0.0 else 0.0 if a[1] == 0.0 else -1.0)


def _pow_iv(a: Interval, y) -> Interval:
    if float(y) != int(y):       # a real exponent: monotone on x >= 0
        if a[0] < 0.0 or (y < 0 and a[0] == 0.0):
            return TOP
        ends = (a[0] ** y, a[1] ** y)
        return _iv(min(ends), max(ends))
    y = int(y)
    if y < 0:
        return _div_iv(_iv(1.0, 1.0), _pow_iv(a, -y))
    if y % 2 == 1:
        return _iv(a[0] ** y, a[1] ** y)
    lo = 0.0 if a[0] <= 0.0 <= a[1] else min(abs(a[0]), abs(a[1])) ** y
    return _iv(lo, max(abs(a[0]), abs(a[1])) ** y)


def _rem_iv(div: Interval) -> Interval:
    """Floored remainder (``torch.remainder``): the divisor's sign."""
    if div[0] > 0.0:
        return _iv(0.0, div[1])
    return TOP


def _numel(node) -> int:
    val = node.meta.get("val")
    return int(val.numel()) if isinstance(val, torch.Tensor) else 1


def _reduce_sum(node, a: Interval) -> Interval:
    n = _numel(node.args[0]) // max(_numel(node), 1)
    return _mul_iv(a, _iv(n, n))


def _convert(node, a: Interval) -> Interval:
    dtype = node.kwargs.get("dtype")
    if dtype is not None and not dtype.is_floating_point:
        # conversion truncates toward zero: within [floor(lo), ceil(hi)]
        return _iv(math.floor(a[0]) if math.isfinite(a[0]) else a[0],
                   math.ceil(a[1]) if math.isfinite(a[1]) else a[1])
    return a


def _clamp(x: Interval, lo, hi) -> Interval:
    lo_b = (-math.inf, -math.inf) if lo is None else lo
    hi_b = (math.inf, math.inf) if hi is None else hi
    return _iv(max(lo_b[0], min(x[0], hi_b[1])),
               min(hi_b[1], max(x[1], lo_b[0])))


def _floored_mod(node, env) -> Interval | None:
    """``q - L·floor(q / L)``, the plain quantize's modulo: [0, L] for
    L > 0 (its body alone would widen to the whole line)."""
    q, m = node.args[0], node.args[1]
    if getattr(m, "target", None) is not torch.ops.aten.mul.Tensor:
        return None
    for fl, lv in (m.args, m.args[::-1]):
        if getattr(fl, "target", None) is not torch.ops.aten.floor.default:
            continue
        dv = fl.args[0]
        if getattr(dv, "target", None) is not torch.ops.aten.div.Tensor:
            continue
        if dv.args[0] is q and (dv.args[1] is lv or dv.args[1] == lv):
            lv_iv = _value(lv, env)
            if lv_iv[0] > 0.0:
                return _iv(0.0, lv_iv[1])
    return None


_UNARY = {
    "abs": _abs_iv, "sqrt": _sqrt_iv, "rsqrt": _rsqrt_iv, "log": _log_iv,
    "exp": _exp_iv, "sign": _sign_iv, "sgn": _sign_iv,
    "neg": lambda a: _iv(-a[1], -a[0]),
    "floor": lambda a: _int_ends(math.floor, a),
    "ceil": lambda a: _int_ends(math.ceil, a),
    "round": lambda a: _int_ends(round, a),
    "trunc": lambda a: _join(_int_ends(math.floor, a),
                             _int_ends(math.ceil, a)),
    "reciprocal": lambda a: _div_iv(_iv(1.0, 1.0), a),
    "tanh": lambda a: _iv(-1.0, 1.0), "sin": lambda a: _iv(-1.0, 1.0),
    "cos": lambda a: _iv(-1.0, 1.0), "sigmoid": lambda a: _iv(0.0, 1.0),
}
# value-preserving: views, copies, reshapes, gathers of elements
_STRUCTURAL = frozenset({
    "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "expand",
    "select", "slice", "permute", "transpose", "t", "clone", "alias",
    "detach", "contiguous", "lift_fresh_copy", "flatten", "index_select",
    "gather", "index", "repeat", "as_strided", "narrow", "amax", "amin",
    "max", "min", "mean", "cummax", "cummin", "constant_pad_nd",
})
_PREDICATES = frozenset({
    "lt", "le", "gt", "ge", "eq", "ne", "logical_and", "logical_or",
    "logical_not", "logical_xor", "isfinite", "isnan", "isinf", "all",
    "any", "bitwise_not",
})


def _value(arg, env) -> Interval:
    if isinstance(arg, torch.fx.Node):
        return env[arg]
    if isinstance(arg, (bool, int, float)):
        return _iv(arg, arg)
    return TOP


def _transfer(node, env) -> Interval:
    name = node.target.overloadpacket.__name__
    raw = node.args
    args = [_value(a, env) if isinstance(a, (torch.fx.Node, int, float))
            else a for a in raw]
    if name in _STRUCTURAL:
        if name in ("max", "min") and len(raw) > 1 \
                and isinstance(raw[1], torch.fx.Node):
            a, b = args[0], args[1]
            f = max if name == "max" else min
            return _iv(f(a[0], b[0]), f(a[1], b[1]))
        return args[0]
    if name in _UNARY:
        return _UNARY[name](args[0])
    if name in _PREDICATES:
        return _iv(0.0, 1.0)
    alpha = float(node.kwargs.get("alpha", 1.0))
    if name == "add":
        b = _mul_iv(args[1], _iv(alpha, alpha))
        return _iv(args[0][0] + b[0], args[0][1] + b[1])
    if name == "sub":
        mod = _floored_mod(node, env)
        if mod is not None:
            return mod
        b = _mul_iv(args[1], _iv(alpha, alpha))
        return _iv(args[0][0] - b[1], args[0][1] - b[0])
    if name == "rsub":
        a = _mul_iv(args[0], _iv(alpha, alpha))
        return _iv(args[1][0] - a[1], args[1][1] - a[0])
    if name == "mul":
        return _mul_iv(args[0], args[1])
    if name == "div":
        q = _div_iv(args[0], args[1])
        mode = node.kwargs.get("rounding_mode")
        return _int_ends(math.floor, q) if mode == "floor" else q
    if name in ("maximum", "fmax"):
        return _iv(max(args[0][0], args[1][0]), max(args[0][1], args[1][1]))
    if name in ("minimum", "fmin"):
        return _iv(min(args[0][0], args[1][0]), min(args[0][1], args[1][1]))
    if name in ("clamp", "clamp_min", "clamp_max"):
        rest = list(raw[1:]) + [None, None]
        lo, hi = {"clamp": rest[:2], "clamp_min": (rest[0], None),
                  "clamp_max": (None, rest[0])}[name]
        lo, hi = node.kwargs.get("min", lo), node.kwargs.get("max", hi)
        return _clamp(args[0], None if lo is None else _value(lo, env),
                      None if hi is None else _value(hi, env))
    if name == "pow" and not isinstance(raw[1], torch.fx.Node):
        return _pow_iv(args[0], raw[1])
    if name == "remainder":
        return _rem_iv(args[1])
    if name in ("sum", "cumsum"):
        return _reduce_sum(node, args[0])
    if name == "where":
        return _join(args[1], args[2])
    if name in ("cat", "stack"):
        return _join(*[_value(a, env) for a in raw[0]])
    if name == "_to_copy":
        return _convert(node, args[0])
    if name in ("full", "full_like", "scalar_tensor", "fill"):
        v = raw[1] if name in ("full", "full_like", "fill") else raw[0]
        return _iv(v, v)
    if name in ("zeros", "zeros_like"):
        return _iv(0.0, 0.0)
    if name in ("ones", "ones_like"):
        return _iv(1.0, 1.0)
    return TOP


def _trace(fn: Callable, example) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn)(*example)


def _propagate(gm: torch.fx.GraphModule, seeds) -> List[Interval]:
    env: Dict = {}
    it = iter(seeds)
    out: List[Interval] = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = _iv(*next(it))
        elif node.op == "get_attr":
            t = getattr(gm, node.target)
            env[node] = (_iv(float(t.min()), float(t.max())) if t.numel()
                         else TOP)
        elif node.op == "call_function":
            env[node] = (_transfer(node, env)
                         if hasattr(node.target, "overloadpacket") else TOP)
        elif node.op == "output":
            res = node.args[0]
            res = res if isinstance(res, (tuple, list)) else [res]
            out = [_value(r, env) for r in res]
    return out


def interval_of(fn: Callable, seeds: List[Interval], *example
                ) -> List[Interval]:
    """Bounds of ``fn``'s outputs, given one interval an argument, from
    its aten graph traced on the example tensors."""
    return _propagate(_trace(fn, example), seeds)


def _ladder() -> List[float]:
    return [2.0 ** k for k in range(LADDER_LO, LADDER_HI + 1)]


def _codec_quantize(pipe, wire, d: int):
    from repro_torch.compression.pipeline import LatticeWire
    from repro_torch.compression.rotation import pad_len
    d_pad = pad_len(d, pipe.block)
    unpacked = LatticeWire(bits=wire.bits, pack=1, levels=wire.levels)
    fn = lambda y, u, g: pipe.quantize(y, u, g, unpacked)  # noqa: E731
    ex = (torch.zeros((2, d_pad)), torch.zeros((2, d_pad)), torch.ones(2))
    return fn, ex


def encode_codes_interval(pipe, wire, d: int) -> Interval:
    """The codes interval of the quantize path (before packing: packing is
    a relayout of in-range codes), for any finite coordinates and any
    positive γ band (the wrap is scale-free)."""
    fn, ex = _codec_quantize(pipe, wire, d)
    seeds = [_iv(-1e30, 1e30), _iv(0.0, 1.0), _iv(1e-12, 1e30)]
    return interval_of(fn, seeds, *ex)[0]


def check_encode_intervals(pipe, wire, d: int, declared_moduli,
                           where: str) -> List[Violation]:
    """The quantize path cannot emit codes past the codec's declared
    moduli."""
    if not declared_moduli:
        return []
    codes = encode_codes_interval(pipe, wire, d)
    l_max = float(max(declared_moduli))
    if codes[0] < 0.0 or codes[1] > l_max:
        return [Violation(
            "gamma-overflow", where,
            f"codes interval [{codes[0]:g}, {codes[1]:g}] escapes the "
            f"declared moduli (max {l_max:g}): wire values can wrap past "
            f"the charged width")]
    return []


def window_margins(margin_fn, bands) -> List[Tuple[float, Interval]]:
    """``(h, margin interval)`` of ``margin_fn(hint, dist, xnorm)`` on each
    hint band [h, 2h], the distance in [0, 2h] (hints bound it), the
    norm free; one trace, one propagation a band."""
    ex = (torch.ones(()), torch.ones(()), torch.ones(()))
    gm = _trace(margin_fn, ex)
    return [(h, _propagate(gm, [_iv(h, 2.0 * h), _iv(0.0, 2.0 * h),
                                _iv(0.0, 1e30)])[0]) for h in bands]


def _window_violations(margins, where: str, what: str) -> List[Violation]:
    for h, m in margins:
        if not (m[0] > 0.0):
            # one band suffices; the derivation is scale-uniform
            return [Violation(
                "gamma-overflow", where,
                f"{what}: wrap margin lower bound {m[0]:g} <= 0 on hint "
                f"band [{h:g}, {2 * h:g}] — snapped codes can wrap past "
                f"the window")]
    return []


def gamma_window_margins(pipe, wire, d: int):
    """The wrap margin through ``pipe.gammas`` on every band of the
    ladder."""
    from repro_torch.compression.pipeline import coord_bound
    from repro_torch.compression.rotation import pad_len
    d_pad = pad_len(d, pipe.block)
    levels = wire.levels if wire.levels is not None else 2.0 ** wire.bits

    def margin(hint, dist, xnorm):
        g = pipe.gammas(hint, xnorm, d, wire)
        return levels / 2.0 - (coord_bound(dist, d_pad) / g + 1.0)
    return window_margins(margin, _ladder())


def check_gamma_window(pipe, wire, d: int, where: str) -> List[Violation]:
    """Lemma 3.1's wrap condition through the pipeline's own γ, at every
    hint scale."""
    return _window_violations(gamma_window_margins(pipe, wire, d), where,
                              f"bits={wire.bits} safety={pipe.safety}")


def rs_gamma_window_margins(pipe, wire_dn, d: int, n_clients: int):
    """The reduce-scatter redistribution's wrap margin through
    ``rs_gamma`` on the summed bands [n·h, 2n·h]."""
    from repro_torch.compression.pipeline import coord_bound
    from repro_torch.compression.rotation import pad_len
    from repro_torch.core.exchange_local import rs_gamma
    d_pad = pad_len(d, pipe.block)

    def margin(h_sum, dist, nrm):
        g, wire_rs = rs_gamma(pipe, wire_dn, h_sum, nrm, d)
        return (2.0 ** wire_rs.bits) / 2.0 \
            - (coord_bound(dist, d_pad) / g[0] + 1.0)
    return window_margins(margin, [n_clients * h for h in _ladder()])


def check_rs_gamma_window(pipe, wire_dn, d: int, n_clients: int,
                          where: str) -> List[Violation]:
    """The same wrap proof for the reduce-scatter aggregate downlink."""
    return _window_violations(
        rs_gamma_window_margins(pipe, wire_dn, d, n_clients), where,
        f"rs bits={wire_dn.bits} n={n_clients} safety={pipe.safety}")
