"""The bf16 grouped kernels' schedule (``csrc/grouped_mm.cu``), emulated on
the CPU in plain torch.

The forward and dgrad kernels run on the card only. This file performs
their arithmetic step by step, as the card does it, at small sizes:

* the host's launch plan (``grouped_mm.rows_plan``: the row tile width BR
  and the split S of the reduction), taken from shapes alone: it runs on
  ``meta`` tensors and never reads ``offs``;
* the row tiles that the CTAs find from ``offs`` (the groups in order, each
  cut into tiles of BR rows, then the rows past ``offs[-1]``; the surplus
  exits);
* the swapped product of each tile, outᵀ = op(W)ᵀ · rowsᵀ over a row box of
  BR rows that may run into the next group and past R (zeros there), with
  W rounded to bf16 on its way to the A operand, fp32 sums in stages of 64;
* the S slices' fp32 partials added in slice order, rounded once.

It holds that emulation against ``grouped_mm_plain`` /
``grouped_mm_dgrad_plain`` (fp32 max|Δ| ≤ 1e-5·max|want|; bf16 ‖Δ‖/‖want‖ ≤
1e-3, the card's gate) and against ``jax.lax.ragged_dot`` and its vjp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_mm as gm

TOL_FP32 = 1e-5
TOL_BF16 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (group sizes, K, N, rows past the last group)
CASES = {
    # empty first and last experts; the 27-row group over two 16-row tiles
    "empty_ends": ([0, 13, 0, 27, 0], 64, 24, 0),
    # all rows in one expert, over three 32-row tiles
    "one_group": ([0, 0, 70, 0], 32, 16, 0),
    # rows past offs[-1] come out zero
    "tail_rows": ([7, 0, 12], 40, 24, 11),
    "one_row": ([0, 1, 0], 16, 8, 0),
    # R below one 8-row tile
    "below_8": ([3, 0, 2], 24, 16, 0),
    # a decode step's rows over a long reduction: S > 1 both ways
    "split_k": ([0, 2, 1, 0, 3], 2048, 1024, 0),
}


def _inputs(name, seed=0):
    sizes, k, n, tail = CASES[name]
    rng = np.random.default_rng(seed)
    rows = sum(sizes) + tail
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    dy = rng.standard_normal((rows, n)).astype(np.float32)
    return x, w, dy, np.asarray(sizes, np.int32)


def _plan(a, w, dgrad):
    """The launch plan from ``meta`` copies of the operands: shapes only."""
    a, w = a.to("meta"), w.to("meta")
    nout = w.shape[1] if dgrad else w.shape[2]
    return gm.rows_plan(a.shape[0], w.shape[0], a.shape[1], nout)


def _tiles(offs, rows, br):
    """(group, first row, row past the last) of each row tile of a launch,
    as the CTAs find them from ``offs``: the groups in order, each in
    ceil(rows / br) tiles, then the rows past offs[-1] as group E; None
    for a surplus tile. The launch has min(R, ceil(R / br) + E) row tiles:
    every tile holds a row, and E + 1 runs of rows make at most
    ceil(R / br) + E tiles."""
    ends = [min(max(int(v), 0), rows) for v in offs]
    e = len(ends)
    out, start = [], 0
    for g, end in enumerate(ends):
        end = max(start, end)
        out += [(g, r, min(end, r + br)) for r in range(start, end, br)]
        start = end
    out += [(e, r, min(rows, r + br)) for r in range(start, rows, br)]
    launched = min(rows, -(-rows // br) + e)
    assert len(out) <= launched
    return out + [None] * (launched - len(out))


def _emulate(a, w, offs, dgrad):
    """fwd: out[r] = a[r] · W[g(r)]; dgrad: out[r] = a[r] · W[g(r)]ᵀ, as
    the card computes them (see the module docstring)."""
    plan = _plan(a, w, dgrad)
    rows, kin = a.shape
    nout = w.shape[1] if dgrad else w.shape[2]
    wa = w.to(a.dtype).float()           # W rounded on its way to A
    pad = torch.cat([a.float(), a.new_zeros(plan.br, kin).float()])
    steps = -(-kin // gm.STEP_K)
    per = -(-steps // plan.splits)
    assert per == plan.steps_per_slice
    part = torch.full((plan.splits, rows, nout), float("nan"))
    for tile in _tiles(offs.tolist(), rows, plan.br):
        if tile is None:
            continue
        g, r0, r1 = tile
        box = pad[r0:r0 + plan.br]       # may run into the next group
        for s in range(plan.splits):
            acc = torch.zeros(nout, plan.br)
            if g < w.shape[0]:
                for step in range(s * per, min(steps, (s + 1) * per)):
                    k0 = step * gm.STEP_K
                    k1 = min(kin, k0 + gm.STEP_K)
                    # A (outputs × reduction) = op(W)ᵀ, B = the row box ᵀ
                    wa_g = wa[g, :, k0:k1] if dgrad else wa[g, k0:k1].T
                    acc += wa_g @ box[:, k0:k1].T
            part[s, r0:r1] = acc.T[:r1 - r0]     # only the tile's rows
    assert not part.isnan().any()        # every (slice, row) written once
    out = part[0].clone()
    for s in range(1, plan.splits):      # the ordered pass
        out += part[s]
    return out.to(a.dtype)


def _close(got, want, dtype):
    got = got.float()
    want = want.float() if isinstance(want, torch.Tensor) else \
        torch.from_numpy(np.array(want, np.float32))
    if dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= TOL_FP32 * float(want.abs().max()), err
    else:
        err = float((got - want).norm())
        assert err <= TOL_BF16 * float(want.norm()), err


@pytest.mark.parametrize("name", list(CASES))
def test_plan_comes_from_shapes_and_tiles_cover_every_row(name):
    x, w, dy, sizes = _inputs(name)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    rows, e = xt.shape[0], wt.shape[0]
    for dgrad, a in ((False, xt), (True, torch.from_numpy(dy))):
        plan = _plan(a, wt, dgrad)
        assert plan.br in gm.ROW_TILES
        assert plan.br >= min(gm.HEADROOM * rows / e, gm.ROW_TILES[-1])
        assert plan.ctas == plan.m_tiles * plan.splits * plan.row_tiles
        assert (plan.splits > 1) == (name == "split_k")
        tiles = [t for t in _tiles(np.cumsum(sizes), rows, plan.br) if t]
        seen = np.zeros(rows, np.int64)
        for g, r0, r1 in tiles:
            assert 0 < r1 - r0 <= plan.br
            lo = int(np.sum(sizes[:g])) if g < e else int(sizes.sum())
            hi = lo + int(sizes[g]) if g < e else rows
            assert lo <= r0 < r1 <= hi
            seen[r0:r1] += 1
        assert (seen == 1).all()
    if name == "one_group":
        assert len(tiles) == 3               # one expert over three tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_emulated_schedule_matches_plain_versions(name, dtype):
    x, w, dy, sizes = _inputs(name)
    offs = torch.from_numpy(np.cumsum(sizes).astype(np.int32))
    xt, dyt = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    wt = torch.from_numpy(w)
    y = _emulate(xt, wt, offs, dgrad=False)
    dx = _emulate(dyt, wt, offs, dgrad=True)
    assert (y.dtype, dx.dtype) == (dtype, dtype)
    _close(y, gm.grouped_mm_plain(xt, wt, offs), dtype)
    _close(dx, gm.grouped_mm_dgrad_plain(dyt, wt, offs), dtype)
    assert not y[int(sizes.sum()):].any() and not dx[int(sizes.sum()):].any()


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_schedule_matches_ragged_dot_and_its_vjp(name):
    x, w, dy, sizes = _inputs(name)
    y_want, vjp = jax.vjp(
        lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(sizes)),
        jnp.asarray(x), jnp.asarray(w))
    dx_want, _ = vjp(jnp.asarray(dy))
    offs = torch.from_numpy(np.cumsum(sizes).astype(np.int32))
    wt = torch.from_numpy(w)
    _close(_emulate(torch.from_numpy(x), wt, offs, dgrad=False),
           np.asarray(y_want), torch.float32)
    _close(_emulate(torch.from_numpy(dy), wt, offs, dgrad=True),
           np.asarray(dx_want), torch.float32)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-scout-17b-a16e"])
def test_plan_at_the_published_expert_shapes(arch):
    """At batch A (2,048 tokens routed) a mean group fits one row tile, so
    each expert's weights are read once, with no split; at a decode step
    (4 tokens) row tiles of 8 rows, and the d_model -> d_ff_expert forward
    splits K over slices of at least MIN_SLICE stages."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    for tokens in (2048, 4):
        rows = tokens * cfg.moe.top_k
        for kin, nout in ((d, f), (f, d)):       # fwd / dgrad of each
            plan = gm.rows_plan(rows, e, kin, nout)
            if tokens == 2048:
                assert plan.br >= gm.HEADROOM * rows / e
                assert plan.splits <= 2      # busy CTAs enough for the card
            else:
                assert plan.br == gm.ROW_TILES[0]
                assert plan.row_tiles == rows    # min(R, ceil(R/8) + E)
                assert plan.steps_per_slice >= gm.MIN_SLICE
        assert gm.rows_plan(4 * cfg.moe.top_k, e, d, f).splits > 1
