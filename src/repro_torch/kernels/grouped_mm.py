"""Grouped matrix products over rows sorted by group: the CUDA kernels of the
MoE's experts and their plain versions.

    grouped_mm(x, w, offs):  Y[r] = x[r] · w[g(r)]       x (R, K), w (E, K, N)

``offs`` (E,) int32 holds the groups' cumulative row ends (group g owns rows
offs[g-1] <= r < offs[g]); rows past offs[-1] belong to no group and come
out zero, as ``jax.lax.ragged_dot``'s. ``grouped_mm`` is a
``torch.autograd.Function``: its forward launches ``grouped_mm_fwd`` and its
backward ``grouped_mm_dgrad`` (dX[r] = dY[r] · w[g(r)]ᵀ) and
``grouped_mm_wgrad`` (dW[g] = x_gᵀ · dY_g). The kernels of
``csrc/grouped_mm.cu`` read ``offs`` on the card, so a round that routes
tokens captures in a CUDA graph.

x and dY come in the compute dtype (fp32 or bf16), w in its stored dtype
(fp32 or bf16): each w value is rounded to the compute dtype as it is
loaded, the values of ``w.to(x.dtype)``. Sums run in fp32 (no TF32), Y and
dX come out in x's dtype, dW is rounded to x's dtype and stored in w's (the
cast's backward).

Each wrapper launches its kernel on CUDA tensors, runs its plain version
(a loop over the groups, which reads ``offs`` on the host) on CPU tensors,
returns empty outputs on ``meta`` tensors, raises on anything else, and
counts its launches in :data:`LAUNCHES`.

In bf16, forward and dgrad run on ``wgmma`` with the weights as the
register operand; :func:`rows_plan` picks their row tile and their split of
the reduction from shapes alone. wgrad runs on ``wgmma`` with the routed
rows as the reduction, in persistent CTAs that walk (expert, 128 × BN tile
of dW) items; :func:`wgrad_plan` picks BN, the ring's stages and the grid
from shapes alone (``csrc/grouped_mm.cu`` sets out both designs).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
ALIGN = 8              # K and N: multiples of 8 (bf16 rows of 16 bytes)
MAX_ROWS = 2**31 - 65  # offs is int32, and the last row tile must fit

# Launches since the last reset_launches(); a wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES = {"grouped_mm_fwd": 0, "grouped_mm_dgrad": 0,
            "grouped_mm_wgrad": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # (a, w, offs, out, part, R, kin, nout, E, x_bf16, w_bf16, dgrad, br,
    #  splits, stream)
    "grouped_mm_rows": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P],
    # (br, w_bf16, stages): the ring's stages, or a CTA's shared memory
    "grouped_rows_plan": [_I, _I, _I],
    # (x, dy, offs, dw, R, K, N, E, x_bf16, w_bf16, bn, stages, ctas,
    #  stream)
    "grouped_mm_wgrad": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    # (bn, w_bf16, stages, E): a wgrad CTA's shared memory
    "grouped_wgrad_plan": [_I, _I, _I, _I],
}

# The bf16 forward and dgrad kernels (csrc/grouped_mm.cu): a CTA owns
# TILE_M of the weights' output columns (dgrad: rows) and one row tile of
# ``br`` rows of one group, and walks the reduction in stages of STEP_K.
ROW_TILES = (8, 16, 32, 64, 128, 256)  # the widths the kernels are built for
TILE_M = 128
STEP_K = 64
HEADROOM = 1.25    # a row tile holds this many times the mean group's rows
SPLIT_WAVES = 8    # with fewer busy CTAs than this many an SM, split K
MIN_SLICE = 8      # stages a slice of the reduction at least
H100_SMS = 132


class RowsPlan(NamedTuple):
    """The launch of a bf16 forward or dgrad: row tiles of ``br`` rows, the
    reduction in ``splits`` ordered slices of ``steps_per_slice`` stages,
    ``ctas`` CTAs (``m_tiles`` × ``splits`` × ``row_tiles``, the surplus
    exits), ``busy`` of them expected to hold rows."""
    br: int
    splits: int
    steps_per_slice: int
    m_tiles: int
    row_tiles: int
    ctas: int
    busy: int


def rows_plan(rows: int, e: int, kin: int, nout: int,
              sms: int = H100_SMS) -> RowsPlan:
    """The bf16 forward's or dgrad's launch from shapes alone (rows R,
    experts E, reduction ``kin``, output width ``nout``, the card's SMs),
    never from ``offs``, so a captured launch fits every routing. ``br``:
    the least built width that holds HEADROOM × R/E rows (a group at batch
    A fits one tile: its weights are read once). ``splits``: 1 unless the
    CTAs that can hold rows (at most min(R, E) + R // br row tiles, times
    the output tiles) are under SPLIT_WAVES × ``sms``; then enough slices
    for that many, each at least MIN_SLICE stages long."""
    br = next((b for b in ROW_TILES if b >= HEADROOM * rows / e),
              ROW_TILES[-1])
    m_tiles = -(-nout // TILE_M)
    steps = -(-kin // STEP_K)
    row_tiles = min(rows, -(-rows // br) + e)   # each holds a row
    busy = max(1, (min(rows, e) + rows // br) * m_tiles)
    splits = 1
    if busy < SPLIT_WAVES * sms:
        splits = max(1, min(-(-SPLIT_WAVES * sms // busy),
                            steps // MIN_SLICE))
    per = -(-steps // splits)
    splits = -(-steps // per)        # no slice left without a stage
    return RowsPlan(br, splits, per, m_tiles, row_tiles,
                    m_tiles * splits * row_tiles, busy)


# The bf16 wgrad kernel: a work item is (expert, WGRAD_TILE_K rows of dW
# held by two consumer warpgroups, BN columns); a stage of its ring is
# WGRAD_STEP routed rows.
WGRAD_TILE_K = 128
WGRAD_TILES_N = (128, 256)   # the widths BN the kernel is built for
WGRAD_STEP = 64
WGRAD_MAX_STAGES = 8
SMEM_OPTIN = 232_448         # shared memory an H100 CTA may opt into


class WgradPlan(NamedTuple):
    """The launch of a bf16 wgrad: dW tiles of WGRAD_TILE_K × ``bn``, a ring
    of ``stages``, ``items`` = E × ``k_tiles`` × ``n_tiles`` work items
    walked by ``ctas`` persistent CTAs of ``smem_bytes`` each."""
    bn: int
    stages: int
    k_tiles: int
    n_tiles: int
    items: int
    ctas: int
    smem_bytes: int


def wgrad_smem(bn: int, w_bytes: int, stages: int, e: int) -> int:
    """A wgrad CTA's shared memory (``WgradPlan::bytes`` of
    ``csrc/grouped_mm.cu``): alignment slack, the staged dW tile (128 × bn
    in W's dtype), ``stages`` ring stages (the x and dY boxes of WGRAD_STEP
    bf16 rows, two mbarriers) and the copy of ``offs``."""
    stage = 2 * WGRAD_STEP * (WGRAD_TILE_K + bn) + 16
    return 1024 + WGRAD_TILE_K * bn * w_bytes + stages * stage + 4 * e


def wgrad_plan(rows: int, e: int, k: int, n: int, w_dtype: torch.dtype,
               sms: int = H100_SMS, bn: int | None = None) -> WgradPlan:
    """The bf16 wgrad's launch from shapes alone (rows R, experts E, dW's
    K × N in ``w_dtype``, the card's SMs), never from ``offs``, so a
    captured launch fits every routing. ``bn`` (unless given): 256 where
    the mean group holds two stages of rows or more (R/E ≥ 2·WGRAD_STEP)
    and N is wider than 128, if two stages fit beside the staged tile;
    else 128, whose ring holds more stages to run ahead of items with few
    rows; ``stages``: as many as fit in SMEM_OPTIN, at most
    WGRAD_MAX_STAGES; ``ctas``: one an SM, at most one an item."""
    w_bytes = w_dtype.itemsize
    wide = rows >= 2 * WGRAD_STEP * e and n > WGRAD_TILES_N[0]
    widths = (bn,) if bn is not None else \
        WGRAD_TILES_N[::-1] if wide else WGRAD_TILES_N[:1]
    for b in widths:
        stage = wgrad_smem(b, w_bytes, 1, 0) - wgrad_smem(b, w_bytes, 0, 0)
        stages = min(WGRAD_MAX_STAGES,
                     (SMEM_OPTIN - wgrad_smem(b, w_bytes, 0, e)) // stage)
        if stages >= 2:
            k_tiles, n_tiles = -(-k // WGRAD_TILE_K), -(-n // b)
            items = e * k_tiles * n_tiles
            return WgradPlan(b, stages, k_tiles, n_tiles, items,
                             min(items, sms),
                             wgrad_smem(b, w_bytes, stages, e))
    raise ValueError(f"E={e}: offs does not fit a wgrad CTA's shared "
                     f"memory beside two stages")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library():
    """The built and loaded ``csrc/grouped_mm.cu``."""
    return build.load("grouped_mm", _SIGNATURES)


def _check(rows, w_shape, w_dtype, offs, *named):
    """Refuse what the kernels do not take: ``named`` (name, tensor, its
    width) 2-D contiguous matrices of ``rows`` rows in one compute dtype;
    w's (E, K, N) with K and N positive multiples of 8 in fp32 or bf16;
    ``offs`` a contiguous (E,) int32 vector."""
    dtype = named[0][1].dtype
    for name, t, width in named:
        if t.dim() != 2 or tuple(t.shape) != (rows, width):
            raise ValueError(f"{name}: expected ({rows}, {width}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype or dtype not in DTYPES:
            raise ValueError(f"{name}: expected one compute dtype of "
                             f"{DTYPES}, got {t.dtype} beside {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len(w_shape) != 3:
        raise ValueError(f"w: expected (E, K, N), got {tuple(w_shape)}")
    e, k, n = w_shape
    if w_dtype not in DTYPES:
        raise ValueError(f"w: dtype {w_dtype} is not one of {DTYPES}")
    if k <= 0 or n <= 0 or k % ALIGN or n % ALIGN:
        raise ValueError(f"K={k}, N={n}: the kernels take positive "
                         f"multiples of {ALIGN}")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows: offs is int32, at most {MAX_ROWS}")
    if (offs.dtype != torch.int32 or offs.dim() != 1
            or offs.shape[0] != e or e < 1 or not offs.is_contiguous()):
        raise ValueError(f"offs: expected a contiguous ({e},) int32 vector "
                         f"with E >= 1, got {tuple(offs.shape)} "
                         f"{offs.dtype}")
    return e, k, n


def _check_w(w):
    if not w.is_contiguous():
        raise ValueError("w must be contiguous (E, K, N): the kernels read "
                         "each expert's K x N block densely")


def _check_tma(*named):
    """The bf16 kernels read rows and weights with TMA, which takes 16-byte
    aligned base addresses and row strides; the strides are (the tensors
    are contiguous, K and N multiples of ALIGN), the addresses of views
    need not be."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the bf16 kernels read it with TMA, "
                             f"which takes 16-byte aligned addresses "
                             f"(got {t.data_ptr()})")


def _spans(offs, rows: int):
    """(group, first row, row past the last) of each group, read on the
    host (the plain versions run on the CPU only); raises unless the row
    ends rise from 0 to at most ``rows``."""
    ends = offs.tolist()
    if any(b < a for a, b in zip([0] + ends, ends)) or ends[-1] > rows:
        raise ValueError(f"offs {ends} must rise from 0 to at most {rows}")
    return list(zip(range(len(ends)), [0] + ends[:-1], ends))


def grouped_mm_plain(x, w, offs):
    """Y[r] = x[r] · w[g(r)].to(x.dtype), one group's rows at a time; rows
    past offs[-1] zero."""
    ws = w.unbind(0)
    parts, end = [], 0
    for g, a, end in _spans(offs, x.shape[0]):
        if end > a:
            parts.append(x[a:end] @ ws[g].to(x.dtype))
    parts.append(x.new_zeros(x.shape[0] - end, w.shape[2]))
    return torch.cat(parts)


def grouped_mm_dgrad_plain(dy, w, offs):
    """dX[r] = dy[r] · w[g(r)].to(dy.dtype)ᵀ; rows past offs[-1] zero."""
    ws = w.unbind(0)
    parts, end = [], 0
    for g, a, end in _spans(offs, dy.shape[0]):
        if end > a:
            parts.append(dy[a:end] @ ws[g].to(dy.dtype).T)
    parts.append(dy.new_zeros(dy.shape[0] - end, w.shape[1]))
    return torch.cat(parts)


def grouped_mm_wgrad_plain(x, dy, offs, *, w_dtype):
    """dW[g] = (x_gᵀ · dy_g in x's dtype).to(w_dtype); zero for a group
    without rows."""
    dw = x.new_zeros((offs.shape[0], x.shape[1], dy.shape[1]),
                     dtype=w_dtype)
    for g, a, b in _spans(offs, x.shape[0]):
        if b > a:
            dw[g] = (x[a:b].T @ dy[a:b]).to(w_dtype)
    return dw


def _rows_cost(a, w, offs):
    """fwd and dgrad: 2·R·K·N flops; a and the output (R·(K + N) values in
    the compute dtype), offs, and the weights of at most min(E, R) experts
    (only an expert with rows is read), from shapes alone."""
    r, (e, k, n) = a.shape[0], w.shape
    return (2.0 * r * k * n,
            r * (k + n) * a.element_size() + 4 * e
            + min(e, r) * k * n * w.element_size())


def _wgrad_cost(x, dy, offs, *, w_dtype):
    """2·R·K·N flops; x and dy read, offs, and all of dW written (an
    expert without rows gets zeros)."""
    (r, k), n, e = x.shape, dy.shape[1], offs.shape[0]
    return (2.0 * r * k * n,
            r * (k + n) * x.element_size() + 4 * e + e * k * n
            * w_dtype.itemsize)


def _launch_rows(a, w, offs, out, dgrad: bool):
    """One launch of the forward or dgrad kernel (with its ordered sum of
    the slices' partials in bf16 when the plan splits K)."""
    rows, kin, nout, e = a.shape[0], a.shape[1], out.shape[1], w.shape[0]
    bf16 = a.dtype == torch.bfloat16
    br, splits, part = 0, 1, None
    if bf16:
        _check_tma(("dy" if dgrad else "x", a), ("w", w))
        br, splits = rows_plan(rows, e, kin, nout,
                               sm_count(a.device.index))[:2]
        if splits > 1:
            part = torch.empty((splits, rows, nout), dtype=torch.float32,
                               device=a.device)
    fn = "grouped_mm_rows"
    build.check(getattr(library(), fn)(
        build.ptr(a), build.ptr(w), build.ptr(offs), build.ptr(out),
        build.ptr(part), rows, kin, nout, e, int(bf16),
        int(w.dtype == torch.bfloat16), int(dgrad), br, splits,
        build.stream()), fn)


@build.costed(lambda *a: _rows_cost(*a)[0], lambda *a: _rows_cost(*a)[1])
def grouped_mm_fwd(x, w, offs):
    """Y (R, N) = x[r] · w[g(r)] in x's dtype.

    Replaces no TPU kernel: it stands in for ``jax.lax.ragged_dot`` of
    ``repro/models/moe.py`` · ``_moe_ragged`` (XLA's own lowering), so that
    the group offsets stay on the card. Bound on the H100: bytes, the fp32
    expert weights (deepseek-v2's batch-A prefill: 5.0 GB a product against
    0.19 TFLOP). Design (``csrc/grouped_mm.cu``): in bf16, wgmma on the
    transposed tile with w, rounded as it is read, as the register operand,
    a TMA ring, row tiles as wide as the groups and an ordered split of K
    for few rows (:func:`rows_plan`); in fp32, one CTA per 64 x 64 output
    tile on FMAs. Row tiles are located from ``offs`` on the card.
    """
    _check_w(w)
    _check(x.shape[0], w.shape, w.dtype, offs, ("x", x, w.shape[1]))
    if build.on_meta(x, w, offs):
        return x.new_empty(x.shape[0], w.shape[2])
    if build.on_cpu(x, w, offs):
        return grouped_mm_plain(x, w, offs)
    out = torch.empty(x.shape[0], w.shape[2], dtype=x.dtype,
                      device=x.device)
    _launch_rows(x, w, offs, out, dgrad=False)
    LAUNCHES["grouped_mm_fwd"] += 1
    return out


@build.costed(lambda *a: _rows_cost(*a)[0], lambda *a: _rows_cost(*a)[1])
def grouped_mm_dgrad(dy, w, offs):
    """dX (R, K) = dy[r] · w[g(r)]ᵀ in dy's dtype: ``grouped_mm_fwd``'s
    tiling with w read transposed (the backward of ``ragged_dot`` with
    respect to its rows)."""
    _check_w(w)
    _check(dy.shape[0], w.shape, w.dtype, offs, ("dy", dy, w.shape[2]))
    if build.on_meta(dy, w, offs):
        return dy.new_empty(dy.shape[0], w.shape[1])
    if build.on_cpu(dy, w, offs):
        return grouped_mm_dgrad_plain(dy, w, offs)
    out = torch.empty(dy.shape[0], w.shape[1], dtype=dy.dtype,
                      device=dy.device)
    _launch_rows(dy, w, offs, out, dgrad=True)
    LAUNCHES["grouped_mm_dgrad"] += 1
    return out


def _launch_wgrad(x, dy, offs, out, plan: WgradPlan | None = None):
    """One launch of the wgrad kernel into ``out`` (E, K, N): in bf16 on
    ``plan`` (:func:`wgrad_plan`'s unless given), in fp32 on the CUDA
    cores."""
    (rows, k), n, e = x.shape, dy.shape[1], offs.shape[0]
    bf16 = x.dtype == torch.bfloat16
    bn = stages = ctas = 0
    if bf16:
        _check_tma(("x", x), ("dy", dy))
        plan = plan or wgrad_plan(rows, e, k, n, out.dtype,
                                  sm_count(x.device.index))
        bn, stages, ctas = plan.bn, plan.stages, plan.ctas
    fn = "grouped_mm_wgrad"
    build.check(getattr(library(), fn)(
        build.ptr(x), build.ptr(dy), build.ptr(offs), build.ptr(out), rows,
        k, n, e, int(bf16), int(out.dtype == torch.bfloat16), bn, stages,
        ctas, build.stream()), fn)


@build.costed(lambda *a, **kw: _wgrad_cost(*a, **kw)[0],
              lambda *a, **kw: _wgrad_cost(*a, **kw)[1])
def grouped_mm_wgrad(x, dy, offs, *, w_dtype):
    """dW (E, K, N) = x_gᵀ · dy_g, rounded to x's dtype, in ``w_dtype``
    (the backward of ``ragged_dot`` with respect to its weights, through
    the cast). In bf16, persistent CTAs walk (expert, 128 × BN tile of dW)
    items (:func:`wgrad_plan`), each summing its group's rows in order on
    wgmma; in fp32 one CTA per (group, 64 x 64 tile) on the CUDA cores. No
    atomics and no split of the rows: reruns bit-identical."""
    k, n = x.shape[1], dy.shape[1]
    _check(x.shape[0], (offs.shape[0], k, n), w_dtype, offs,
           ("x", x, k), ("dy", dy, n))
    if build.on_meta(x, dy, offs):
        return x.new_empty((offs.shape[0], k, n), dtype=w_dtype)
    if build.on_cpu(x, dy, offs):
        return grouped_mm_wgrad_plain(x, dy, offs, w_dtype=w_dtype)
    out = torch.empty((offs.shape[0], k, n), dtype=w_dtype, device=x.device)
    _launch_wgrad(x, dy, offs, out)
    LAUNCHES["grouped_mm_wgrad"] += 1
    return out


class _GroupedMM(torch.autograd.Function):
    """The forward kernel; its backward the dgrad and wgrad kernels."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return grouped_mm_fwd(x, w, offs)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_mm_dgrad(dy, w, offs) if ctx.needs_input_grad[0] \
            else None
        dw = grouped_mm_wgrad(x, dy, offs, w_dtype=w.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_mm(x, w, offs):
    """Y[r] = x[r] · w[g(r)] over rows sorted by group, differentiable in x
    and w (see the module docstring); x (R, K) fp32 or bf16, w (E, K, N)
    fp32 or bf16 contiguous, offs (E,) int32 cumulative row ends."""
    return _GroupedMM.apply(x, w, offs)
