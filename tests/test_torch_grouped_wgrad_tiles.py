"""The bf16 grouped wgrad's schedule (``csrc/grouped_mm.cu``,
``grouped_wgrad_wgmma_kernel``), emulated on the CPU in plain torch.

The kernel runs on the card only. This file performs its arithmetic step by
step, as the card does it, at small sizes:

* the host's launch plan (``grouped_mm.wgrad_plan``: the dW tile width BN,
  the ring's stages, the persistent grid), taken from shapes alone: it runs
  on ``meta`` tensors and never reads ``offs``;
* the work items, (expert, 128 rows of dW's K, BN of its N), walked by the
  persistent CTAs c, c + grid, ...: every (expert, tile) once;
* stages of 64 routed rows from each group's first row, the group's last,
  partial stage in boxes of 16 rows; boxes that may run into the next
  group's rows or past R (zeros there, as TMA reads them), with the rows at
  or past the group's end zeroed before the product;
* bf16 products summed in fp32 in wgmma steps of 16 rows, in row order,
  rounded to bf16, then to W's dtype; an expert without rows gets a zero
  tile.

It holds that emulation against ``grouped_mm_wgrad_plain`` (fp32 max|Δ| ≤
1e-5·max|want|; bf16 ‖Δ‖/‖want‖ ≤ 1e-3, the card's gate) and against the
weight vjp of ``jax.lax.ragged_dot``, also where the rows outside every
group hold NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_mm as gm

TOL_FP32 = 1e-5
TOL_BF16 = 1e-3
SMS = 3     # a small grid, so that each CTA walks several items


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (group sizes, K, N, rows past the last group, whether those hold NaN)
CASES = {
    # ragged with empty groups, the first and last among them; groups over
    # several stages, and a group of one row
    "ragged": ([0, 130, 7, 0, 64, 1, 300, 0], 256, 192, 0, False),
    "empty_ends": ([0, 13, 0, 27, 0], 64, 24, 0, False),
    # R below one 64-row stage
    "below_a_tile": ([3, 0, 2], 64, 128, 0, False),
    # rows past offs[-1]; K and N not multiples of the tile
    "tail_rows": ([40, 0, 25], 200, 136, 11, False),
    # rows of no group hold NaN in x and dy, inside both groups' last
    # stages; N over two 256-wide tiles, the second 8 wide
    "nan_outside": ([0, 70, 0, 5], 136, 264, 57, True),
    # groups of two stages or more on average: the plan's BN is 256
    "wide_groups": ([260, 0, 140], 128, 264, 0, False),
}


def _inputs(name, seed=0):
    sizes, k, n, tail, poison = CASES[name]
    rng = np.random.default_rng(seed)
    rows = sum(sizes) + tail
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    dy = rng.standard_normal((rows, n)).astype(np.float32)
    if poison:
        x[sum(sizes):] = np.nan
        dy[sum(sizes):] = np.nan
    return x, w, dy, np.asarray(sizes, np.int32)


def _plan(x, dy, offs, w_dtype, bn=None):
    """The launch plan from ``meta`` copies of the operands: shapes only."""
    x, dy, offs = x.to("meta"), dy.to("meta"), offs.to("meta")
    return gm.wgrad_plan(x.shape[0], offs.shape[0], x.shape[1], dy.shape[1],
                         w_dtype, SMS, bn=bn)


def _box(a, r, height, c0, width):
    """The TMA boxes of ``a`` at rows r ... r + height - 1, columns c0 ...
    c0 + width - 1: zeros past R and past the last column."""
    box = a.new_zeros(height, width)
    part = a[r:r + height, c0:c0 + width]
    box[:part.shape[0], :part.shape[1]] = part
    return box


def _emulate(x, dy, offs, w_dtype, plan, seen=None):
    """dW[g] = x_gᵀ · dy_g as the card computes it (see the module
    docstring); ``seen`` counts each (expert, K tile, N tile) an item
    covers, and the stages whose boxes held NaN before the zeroing."""
    (rows, k), n, e = x.shape, dy.shape[1], offs.shape[0]
    tk, bn = gm.WGRAD_TILE_K, plan.bn
    assert plan.k_tiles == -(-k // tk) and plan.n_tiles == -(-n // bn)
    assert plan.items == e * plan.k_tiles * plan.n_tiles
    ends = [min(max(int(v), 0), rows) for v in offs.tolist()]
    dw = torch.full((e, k, n), float("nan"), dtype=w_dtype)
    for c in range(plan.ctas):
        for t in range(c, plan.items, plan.ctas):
            g, rest = divmod(t, plan.k_tiles * plan.n_tiles)
            k0, n0 = (rest // plan.n_tiles) * tk, (rest % plan.n_tiles) * bn
            start = ends[g - 1] if g else 0
            end = max(start, ends[g])
            acc = torch.zeros(tk, bn)
            for r in range(start, end, gm.WGRAD_STEP):
                valid = end - r         # a partial stage: boxes of 16 rows
                steps = 4 if valid >= gm.WGRAD_STEP else -(-valid // 16)
                xb = _box(x, r, 16 * steps, k0, tk)
                db = _box(dy, r, 16 * steps, n0, bn)
                if seen is not None:
                    seen["nan_stages"] += int(bool(xb.isnan().any()
                                                   or db.isnan().any()))
                xb[valid:] = 0          # rows at or past the group's end
                db[valid:] = 0
                for j in range(0, 16 * steps, 16):      # wgmma's k16 steps
                    acc += xb[j:j + 16].float().T @ db[j:j + 16].float()
            tile = acc.to(x.dtype).to(w_dtype)
            dw[g, k0:k0 + tk, n0:n0 + bn] = tile[:k - k0, :n - n0]
            if seen is not None:
                seen["tiles"][g, k0 // tk, n0 // bn] += 1
    assert not dw.isnan().any()          # every element written
    return dw


def _close(got, want, dtype):
    """The fp32 gate where the compute dtype and dW's are fp32, else the
    bf16 one (dW rounded to bf16 on either side)."""
    lossy = torch.bfloat16 in (dtype, got.dtype)
    got = got.float()
    want = want.float() if isinstance(want, torch.Tensor) else \
        torch.from_numpy(np.array(want, np.float32))
    if not lossy:
        err = float((got - want).abs().max())
        assert err <= TOL_FP32 * float(want.abs().max()), err
    else:
        err = float((got - want).norm())
        assert err <= TOL_BF16 * float(want.norm()), err


def _tensors(name, dtype):
    x, w, dy, sizes = _inputs(name)
    offs = torch.from_numpy(np.cumsum(sizes).astype(np.int32))
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype),
            offs, sizes)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_plan_comes_from_shapes_and_items_cover_every_tile(name, w_dtype):
    x, dy, offs, sizes = _tensors(name, torch.bfloat16)
    (rows, k), n, e = x.shape, dy.shape[1], offs.shape[0]
    meta = gm.grouped_mm_wgrad(x.to("meta"), dy.to("meta"), offs.to("meta"),
                               w_dtype=w_dtype)
    assert (meta.device.type, meta.shape, meta.dtype) == \
        ("meta", (e, k, n), w_dtype)
    for bn in (None, *gm.WGRAD_TILES_N):
        plan = _plan(x, dy, offs, w_dtype, bn)
        assert plan == gm.wgrad_plan(rows, e, k, n, w_dtype, SMS, bn=bn)
        wide = rows >= 2 * gm.WGRAD_STEP * e and n > 128
        assert plan.bn == (bn or (256 if wide else 128))
        assert wide == (name == "wide_groups")
        assert 2 <= plan.stages <= gm.WGRAD_MAX_STAGES
        assert plan.smem_bytes == gm.wgrad_smem(plan.bn, w_dtype.itemsize,
                                                plan.stages, e)
        assert plan.smem_bytes <= gm.SMEM_OPTIN
        assert plan.stages == gm.WGRAD_MAX_STAGES or gm.wgrad_smem(
            plan.bn, w_dtype.itemsize, plan.stages + 1, e) > gm.SMEM_OPTIN
        assert plan.ctas == min(plan.items, SMS)
        seen = {"tiles": np.zeros((e, plan.k_tiles, plan.n_tiles), np.int64),
                "nan_stages": 0}
        _emulate(x, dy, offs, w_dtype, plan, seen)
        assert (seen["tiles"] == 1).all()
        # the poisoned rows reach the boxes: only the zeroing keeps them out
        assert (seen["nan_stages"] > 0) == CASES[name][4]


@pytest.mark.parametrize("bn", gm.WGRAD_TILES_N)
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_emulated_schedule_matches_plain_version(name, dtype, w_dtype, bn):
    x, dy, offs, sizes = _tensors(name, dtype)
    plan = _plan(x, dy, offs, w_dtype, bn)
    dw = _emulate(x, dy, offs, w_dtype, plan)
    want = gm.grouped_mm_wgrad_plain(x, dy, offs, w_dtype=w_dtype)
    assert dw.dtype == want.dtype == w_dtype
    _close(dw, want, dtype)
    assert not dw[sizes == 0].any()      # an expert without rows: zeros


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_schedule_matches_ragged_dot_weight_vjp(name):
    x, w, dy, sizes = _inputs(name)
    _, vjp = jax.vjp(
        lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(sizes)),
        jnp.asarray(x), jnp.asarray(w))
    _, dw_want = vjp(jnp.asarray(dy))
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    offs = torch.from_numpy(np.cumsum(sizes).astype(np.int32))
    # bf16 W: the cast's backward rounds the reference's dW to bf16 too
    for w_dtype, want in ((torch.float32, dw_want),
                          (torch.bfloat16, dw_want.astype(jnp.bfloat16))):
        plan = _plan(xt, dyt, offs, w_dtype)
        _close(_emulate(xt, dyt, offs, w_dtype, plan),
               np.asarray(want.astype(jnp.float32)), torch.float32)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-scout-17b-a16e"])
def test_plan_at_the_published_expert_shapes(arch):
    """Both products of each arch (K d_model, N d_ff_expert and back), at
    batch A (2,048 tokens routed) and a decode step (4), fp32 and bf16 W:
    one CTA on each of the H100's 132 SMs, every CTA with many items, the
    ring and the staged tile inside the shared memory a CTA may opt into.
    BN 256 only where the mean group holds two stages of rows: scout's
    batch A (128 rows an expert), not deepseek-v2's (77) nor a decode
    step, which take BN 128 and its deeper ring."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    for tokens in (2048, 4):
        rows = tokens * cfg.moe.top_k
        wide = tokens == 2048 and arch.startswith("llama4")
        for k, n in ((d, f), (f, d)):
            for w_dtype in (torch.float32, torch.bfloat16):
                plan = gm.wgrad_plan(rows, e, k, n, w_dtype)
                assert plan.bn == (256 if wide else 128)
                assert plan.stages == {(256, 4): 2, (256, 2): 3, (128, 4): 5,
                                       (128, 2): 6}[plan.bn,
                                                    w_dtype.itemsize]
                assert plan.ctas == gm.H100_SMS
                assert plan.items >= 100 * plan.ctas
                assert plan.smem_bytes <= gm.SMEM_OPTIN
