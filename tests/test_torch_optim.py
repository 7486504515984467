"""The optimizers (``repro_torch.optim``: sgd, sgd with momentum, adam)
against the JAX reference's ``repro.optim`` on the same gradients, and the
reference's own quadratic cases (``tests/test_infra.py``).

Tolerances: the updates and the state within 1e-6 of max |want| over 20
steps; the quadratic's minimum within 1e-2, as the reference's test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import gauss, npy, tt
from repro import optim as ref_optim
from repro_torch import optim

TOL, STEPS = 1e-6, 20
SHAPES = {"w": (8, 16), "b": (16,), "s": ()}
OPTS = [("sgd", {"lr": 0.1}), ("sgd", {"lr": 0.1, "momentum": 0.9}),
        ("adam", {"lr": 0.05}),
        ("adam", {"lr": 1e-3, "b1": 0.8, "b2": 0.99, "eps": 1e-6})]


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(npy(got) - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _state_leaves(state):
    """The state's tensors by name: () for sgd, the momentum dict, or
    adam's mu, nu and count."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        out = {f"mu/{k}": v for k, v in state.mu.items()}
        out.update({f"nu/{k}": v for k, v in state.nu.items()})
        out["count"] = state.count
        return out
    return dict(state) if state != () else {}


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=["sgd", "momentum", "adam", "adam_b1_b2_eps"])
def test_updates_and_state_match_reference(name, kw):
    """20 steps on the same gradients (a numpy seed a step, the parameters
    moved by each step's updates on both sides)."""
    ref, port = getattr(ref_optim, name)(**kw), getattr(optim, name)(**kw)
    p_ref = {k: jnp.asarray(gauss(i, s)) for i, (k, s) in
             enumerate(SHAPES.items())}
    p = {k: tt(np.asarray(v)) for k, v in p_ref.items()}
    s_ref, s = ref.init(p_ref), port.init(p)
    for step in range(STEPS):
        g_np = {k: gauss(100 * step + i, sh) for i, (k, sh) in
                enumerate(SHAPES.items())}
        u_ref, s_ref = ref.update({k: jnp.asarray(v) for k, v in
                                   g_np.items()}, s_ref, p_ref)
        u, s = port.update({k: tt(v) for k, v in g_np.items()}, s, p)
        for k in SHAPES:
            _close(u[k], u_ref[k], (step, k))
            assert u[k].dtype == torch.float32
        want = _state_leaves(s_ref)
        got = _state_leaves(s)
        assert got.keys() == want.keys()
        for k, v in want.items():
            _close(got[k], v, (step, k))
        p_ref = {k: p_ref[k] - u_ref[k] for k in p_ref}
        p = {k: p[k] - u[k] for k in p}
    if name == "adam":
        assert int(s.count) == STEPS and s.count.dtype == torch.int32


@pytest.mark.parametrize("opt", [optim.sgd(0.1), optim.sgd(0.1, momentum=0.9),
                                 optim.adam(0.05)],
                         ids=["sgd", "momentum", "adam"])
def test_optimizers_minimize_quadratic(opt):
    """The reference's case: 200 steps on |w|^2 from (3, -2, 1.5)."""
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        upd, state = opt.update(grads, state, params)
        params = {"w": params["w"] - upd["w"]}
    assert float(torch.linalg.vector_norm(params["w"])) < 1e-2


def test_adam_moments_are_fp32_for_bf16_gradients():
    """Adam's moments and updates are fp32 whatever the gradients' dtype,
    as the reference's; the inputs are not written."""
    opt = optim.adam(0.01)
    p = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    s = opt.init(p)
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    u, s2 = opt.update(g, s, p)
    assert s2.mu["w"].dtype == s2.nu["w"].dtype == u["w"].dtype == \
        torch.float32
    assert float(s.mu["w"].abs().max()) == 0.0 and int(s.count) == 0
    ref = ref_optim.adam(0.01)
    rp = {"w": jnp.ones((4,), jnp.bfloat16)}
    ru, _ = ref.update({"w": jnp.full((4,), 0.5, jnp.bfloat16)},
                       ref.init(rp), rp)
    _close(u["w"], ru["w"], "bf16")
