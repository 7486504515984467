"""Federated LM training of the rest of the decoder zoo in the port (an
MoE arch and mamba2-370m through the registry's QuAFL, a cohort-mode arch
through the mesh train step, the round engine's chunks) against the JAX
reference at the reduced configs.

The reference's draws are injected through ``tests/test_torch_harness.py``.
Tolerances: bits exact; QuAFL's server within one lattice step (the
largest γ of the round's messages), as ``tests/test_torch_train.py``; the
mesh round's server within ‖Δ‖/‖X‖ ≤ 1e-4 per leaf and quant_err within
1e-4 relative, as ``tests/test_torch_spmd.py``; chunks equal to eager bit
for bit.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import (npy, reference_round_draws,
                                reference_step_draws, tt)
from test_torch_train import _gamma_log
from test_torch_zoo import one_thread, port_lm  # noqa: F401
from repro import configs as ref_configs
from repro.configs.base import FedConfig as RefFedConfig
from repro.data import synthetic as ref_synth
from repro.fed.registry import make_algorithm as ref_make_algorithm
from repro.launch.spmd import SpmdAlgorithm as RefSpmd
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.compression.rotation import pad_len
from repro_torch.configs.base import FedConfig
from repro_torch.data import synthetic
from repro_torch.fed import make_algorithm
from repro_torch.launch import train
from repro_torch.models import model

# the reference's mesh round compiles with LLVM's cheap pipeline (the same
# program, in about 80% of the compile time)
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


N, S, K, B, POOL, SEQ, LR = 3, 2, 2, 2, 8, 24, 0.05


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mamba2-370m"])
def test_quafl_rounds_match_reference(arch):
    """Two QuAFL rounds of a reduced MoE arch and of mamba2 under the
    per-client protocol (the MoE aux in each client's objective), the
    port's state carried on its own, every draw the reference's."""
    rcfg, cfg, rp, pp = port_lm(arch)
    rdata, rbatch = ref_synth.federated_token_task(0, N, POOL, B, SEQ,
                                                   cfg.vocab_size)
    fed = dict(n_clients=N, s=S, local_steps=K, lr=LR, bits=8)
    rpj = {k: jnp.asarray(v) for k, v in rp.items()}
    ref = ref_make_algorithm("quafl", RefFedConfig(**fed), loss_fn=partial(
        ref_model.lm_loss, rcfg), template=rpj, batch_fn=rbatch)
    port = make_algorithm("quafl", FedConfig(**fed), loss_fn=partial(
        model.lm_loss, cfg), template=train.shape_template(pp),
        batch_fn=synthetic.token_batch, batch_size=B, device="cpu")
    gammas = _gamma_log(port.pipeline)
    rs, ps = ref.init(rpj), port.init(pp)
    pdata = {"tokens": tt(rdata["tokens"])}
    msg = pad_len(port.d) * 8 + 32
    g = torch.Generator()
    for r in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(11), r)
        draws = reference_round_draws(ref, rs, rdata, key, B)
        ps, pm = port.round(ps, pdata, g,
                            draws={k: tt(v) for k, v in draws.items()})
        rs, _ = ref.round(rs, rdata, key)
        step = max(gammas)
        err = np.abs(npy(ps.server) - np.asarray(rs.server)).max()
        assert err <= step, (r, err, step)
        assert float(pm["bits_up"]) == S * msg
        assert float(pm["bits_down"]) == msg
    assert float(ps.bits_up) == 2 * S * msg


def test_spmd_round_of_a_cohort_arch_matches_reference():
    """One ``SpmdAlgorithm.round`` of reduced deepseek-v2 (cohort mode:
    FSDP rules, s = 1) on the (1, 1) mesh: bits and sim_time exact, the
    server within 1e-4 per leaf (‖Δ‖/‖X‖), quant_err within 1e-4."""
    from repro_torch.launch.steps import fed_mode_for
    arch, b, seq = "deepseek-v2-236b", 2, 16
    assert fed_mode_for(arch) == "cohort"
    cfg = configs.get_reduced(arch)
    p0, _ = model.init_lm(cfg, seed=0, device="cpu")
    fed = dict(local_steps=K, lr=LR, bits=8, transport="dequant_psum",
               n_clients=1, s=1)
    alg = make_algorithm("spmd", FedConfig(**fed), loss_fn=None,
                         template=p0, cfg=cfg, batch=b, seq=seq,
                         device="cpu")
    assert alg._step.fed_mode == "cohort"
    data, _ = synthetic.federated_token_task(0, 1, 16, b, seq,
                                             cfg.vocab_size, device="cpu")
    rp = {k: jnp.asarray(npy(v)) for k, v in p0.items()}
    ref = RefSpmd(fed=RefFedConfig(**fed), template=rp,
                  cfg=ref_configs.get_reduced(arch), batch=b, seq=seq)
    rdata = {"tokens": jnp.asarray(npy(data["tokens"]))}
    key = jax.random.PRNGKey(5)
    args = (ref.init(rp), rdata, key)
    rst, rm = RefSpmd.round.lower(ref, *args).compile(
        compiler_options=CHEAP)(*args)
    k_b, k_r = jax.random.split(key)
    draws = reference_step_draws(alg._step, jax.random.key_data(k_r),
                                 {"data": 0, "model": 0})
    draws["rows"] = tt(npy(jax.random.randint(
        k_b, (1, K, b), 0, data["tokens"].shape[1])))
    st, m = alg.round(alg.init(p0), data, None, draws)
    assert m["bits_up"] == float(rm["bits_up"]) == alg._bits_up_msg
    assert m["bits_down"] == float(rm["bits_down"])
    assert float(m["sim_time"]) == float(rm["sim_time"])
    assert abs(float(m["quant_err"]) - float(rm["quant_err"])) <= \
        1e-4 * float(rm["quant_err"])
    for k in rp:
        x = np.asarray(rst.train.server[k])
        d = np.linalg.norm(npy(st.train.server[k]) - x)
        assert d <= 1e-4 * np.linalg.norm(x), k


def test_scan_chunk_refuses_moe_archs(capsys):
    """``--scan-chunk`` runs every arch, as the reference's: the MoE's group
    offsets stay on the device (``models/moe.group_offsets``), so reduced
    deepseek-v2 runs in chunks, equal to eager bit for bit; so does
    mamba2. (The name is the refusal's, which is gone.)"""
    cli = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
           "--seq", "16", "--pool", "8", "--log-every", "1", "--algo",
           "quafl"]
    for arch in ("deepseek-v2-236b", "mamba2-370m"):
        eager = train.main(cli + ["--arch", arch])
        chunked = train.main(cli + ["--arch", arch, "--scan-chunk", "2"])
        assert chunked.trace.engine == "scanned", arch
        assert torch.equal(eager.trace.final_state.server,
                           chunked.trace.final_state.server), arch
        for a, b in zip(eager.trace.rows, chunked.trace.rows):
            assert (a["bits_up"], a["bits_down"]) == \
                (b["bits_up"], b["bits_down"]), arch
