"""The MoE's grouped product (``kernels/grouped_mm.py``) on the CPU.

* ``grouped_mm_plain`` and ``grouped_mm`` (its ``autograd.Function``, whose
  backward runs the dgrad and wgrad plain versions here) against
  ``jax.lax.ragged_dot`` and its ``jax.vjp``, on the same numpy inputs from
  a seed: random sizes, empty first and last groups, all rows in one group,
  rows past the last group (zero, as ragged_dot's); fp32 within
  1e-5·max|want| for Y, dX and dW (sums in another order); bf16 weights
  under an fp32 x take the values of ``w.astype(x.dtype)``;
* the wrapper's refusals;
* the meta branch's shapes and dtypes, and the cost walker's count of a
  forward and backward equal on ``meta`` and on the CPU;
* one QuAFL round of reduced deepseek-v2 (``RoundEngine.traced_round``)
  reads nothing on the host (``check_host_syncs`` empty): the group
  offsets stay on the device.

The kernels themselves run only on the card (``test_grouped_mm_*`` in
``tests/test_torch_cuda.py``).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import grouped_mm as gm
from repro_torch.launch.hlocost import CostWalker

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes gain nothing from intra-op threads, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (rows, group sizes): random, empty first and last, all in one group,
# rows past the last group, a single row
CASES = {
    "random": (None, 6),
    "empty_ends": (40, [0, 13, 0, 27, 0]),
    "one_group": (33, [0, 0, 33, 0]),
    "tail_rows": (30, [7, 0, 12]),
    "one_row": (1, [0, 1, 0]),
}


def _case(name, k=16, n=24, seed=0):
    rows, sizes = CASES[name]
    rng = np.random.default_rng(seed)
    if sizes is None or isinstance(sizes, int):
        sizes = rng.multinomial(50, np.ones(sizes) / sizes).tolist()
        rows = sum(sizes)
    e = len(sizes)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    dy = rng.standard_normal((rows, n)).astype(np.float32)
    return x, w, dy, np.asarray(sizes, np.int32)


def _want(x, w, dy, sizes):
    """ragged_dot's output and its vjp against dy."""
    y, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b,
                                                     jnp.asarray(sizes)),
                     jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dy))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _close(got, want, what):
    got = got.detach().float().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _offs(sizes):
    return torch.from_numpy(np.cumsum(sizes).astype(np.int32))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("via", ["plain", "autograd_function"])
def test_grouped_mm_matches_ragged_dot_and_its_vjp(name, via):
    x, w, dy, sizes = _case(name)
    want = _want(x, w, dy, sizes)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    fn = gm.grouped_mm_plain if via == "plain" else gm.grouped_mm
    y = fn(xt, wt, _offs(sizes))
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    for got, ref, what in zip((y, dx, dw), want, ("y", "dx", "dw")):
        _close(got, ref, what)
    empty = [g for g, s in enumerate(sizes) if s == 0]
    assert not dw[empty].any()
    assert not y[int(sizes.sum()):].any()


def test_bf16_weights_take_the_values_of_their_cast():
    """An fp32 x against bf16 weights: the values of ``w.astype(fp32)``;
    dW rounded back to bf16 (the cast's backward)."""
    x, w, dy, sizes = _case("empty_ends")
    wb = torch.from_numpy(w).to(torch.bfloat16)
    y_want, dx_want, dw_want = _want(x, wb.float().numpy(), dy, sizes)
    wt = wb.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = gm.grouped_mm(xt, wt, _offs(sizes))
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    assert y.dtype == dx.dtype == torch.float32 and dw.dtype == torch.bfloat16
    _close(y, y_want, "y")
    _close(dx, dx_want, "dx")
    # one bf16 rounding of each sum: half an ulp, 2^-9 of the value
    err = float(np.abs(dw.float().numpy() - dw_want).max())
    assert err <= 2.0 ** -8 * float(np.abs(dw_want).max())


def test_bf16_compute_rounds_as_the_cast_does():
    """bf16 x and fp32 weights: each expert product equals ``x_g @
    w[g].to(bf16)``, and dW is that product's backward cast to fp32."""
    x, w, dy, sizes = _case("random")
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wt, offs = torch.from_numpy(w), _offs(sizes)
    y = gm.grouped_mm(xb, wt, offs)
    assert y.dtype == torch.bfloat16
    start = 0
    for g, end in enumerate(offs.tolist()):
        assert torch.equal(y[start:end], xb[start:end] @ wt[g].to(
            torch.bfloat16))
        start = end
    dyb = torch.from_numpy(dy).to(torch.bfloat16)
    dw = gm.grouped_mm_wgrad(xb, dyb, offs, w_dtype=torch.float32)
    assert dw.dtype == torch.float32
    assert torch.equal(dw[0], (xb[:sizes[0]].T @ dyb[:sizes[0]]).float())


@pytest.mark.parametrize("bad,match", [
    (dict(k=12), "multiples of 8"),
    (dict(n=20), "multiples of 8"),
    (dict(w_t=True), "contiguous"),
    (dict(x_dtype=torch.float16), "compute dtype"),
    (dict(w_dtype=torch.float64), "dtype"),
    (dict(offs_len=2), "offs"),
    (dict(offs_dtype=torch.int64), "offs"),
    (dict(x_cols=8), r"expected \(5, 16\)"),
    (dict(mixed=True), "meta tensors only together"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(bad, match):
    k, n = bad.get("k", 16), bad.get("n", 24)
    x = torch.zeros(5, bad.get("x_cols", k),
                    dtype=bad.get("x_dtype", torch.float32))
    w = torch.zeros(3, k, n, dtype=bad.get("w_dtype", torch.float32))
    if bad.get("w_t"):
        w = torch.zeros(3, n, k).transpose(1, 2)
    offs = torch.tensor([1, 3, 5][:bad.get("offs_len", 3)],
                        dtype=bad.get("offs_dtype", torch.int32))
    if bad.get("mixed"):
        offs = offs.to("meta")
    with pytest.raises(ValueError, match=match):
        gm.grouped_mm(x, w, offs)


def test_plain_version_refuses_offsets_that_fall():
    with pytest.raises(ValueError, match="rise"):
        gm.grouped_mm_plain(torch.zeros(5, 8), torch.zeros(2, 8, 8),
                            torch.tensor([4, 2], dtype=torch.int32))


def _walk(dev, grad):
    x, w, dy, sizes = _case("empty_ends")
    xt = torch.from_numpy(x).to(dev).requires_grad_(grad)
    wt = torch.from_numpy(w).to(dev).to(torch.bfloat16).requires_grad_(grad)
    offs, dyt = _offs(sizes).to(dev), torch.from_numpy(dy).to(dev)
    walker = CostWalker(records=True)
    with torch.set_grad_enabled(grad), walker:
        y = gm.grouped_mm(xt, wt, offs)
        outs = [y]
        if grad:
            outs += torch.autograd.grad(y, (xt, wt), dyt)
    return walker, outs


@pytest.mark.parametrize("grad", [False, True])
def test_meta_branch_shapes_and_walker_count_equal_the_cpu(grad):
    (wm, meta), (wc, cpu) = _walk("meta", grad), _walk("cpu", grad)
    assert [(t.shape, t.dtype) for t in meta] == \
        [(t.shape, t.dtype) for t in cpu]
    assert all(t.device.type == "meta" for t in meta)
    assert (wm.flops, wm.bytes, dict(wm.kernels)) == \
        (wc.flops, wc.bytes, dict(wc.kernels))
    rows, k, n, e = 40, 16, 24, 5
    per = 2.0 * rows * k * n
    want = {"grouped_mm_fwd": 1}
    if grad:
        want.update(grouped_mm_dgrad=1, grouped_mm_wgrad=1)
    assert dict(wc.kernels) == want
    assert wc.kernel_flops == per * len(want)
    # fwd: x, y and offs, and min(E, R) = 5 experts of bf16 weights
    fwd = rows * (k + n) * 4 + 4 * e + e * k * n * 2
    assert [r[1] for r in wc.records if r[0] == "grouped_mm_fwd"] == [fwd]


def test_a_round_of_deepseek_reads_nothing_on_the_host():
    """The op log of one QuAFL round of reduced deepseek-v2 (router, sort,
    group offsets, three grouped products forward and backward in every
    local step) holds no host read."""
    from repro_torch.analysis.jaxpr import check_host_syncs
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synthetic import federated_token_task
    from repro_torch.fed import make_algorithm
    from repro_torch.fed.engine import RoundEngine
    from repro_torch.launch.train import shape_template
    from repro_torch.models.model import init_lm, lm_loss
    cfg = configs.get_reduced("deepseek-v2-236b")
    fed = FedConfig(n_clients=3, s=2, local_steps=2, lr=0.05, bits=8)
    data, batch_fn = federated_token_task(0, 3, 8, 2, 16, cfg.vocab_size,
                                          device="cpu")
    params, _ = init_lm(cfg, seed=0, device="cpu")
    alg = make_algorithm("quafl", fed, loss_fn=partial(lm_loss, cfg),
                         template=shape_template(params), batch_fn=batch_fn,
                         batch_size=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    trace = RoundEngine(alg).traced_round(alg.init(params), data, gen)
    names = {op.name for op in trace.ops}
    assert {"scatter_add", "cumsum"} <= names or \
        {"scatter_add_", "cumsum"} <= names, sorted(names)
    assert check_host_syncs(trace, "deepseek") == []
