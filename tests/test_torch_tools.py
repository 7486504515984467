"""The dry-run tools of the port (``configs`` SHAPES and the long-context
variant, ``launch/{roofline,hlocost,dryrun,profile_pair}.py``, the abstract
mesh, the kernel wrappers' ``meta`` branches and the shard_map MoE)
against the reference on the CPU.

* ``SHAPES``, the long-context fields and ``with_long_variant()`` equal the
  reference's for all ten archs, and so does ``shape_skip_reason``;
* ``active_params`` equals the reference's exactly and ``model_flops`` to
  1e-12 relative, every arch × shape × n_slots in {1, 16};
* the reference's roofline test holds at the H100's peaks;
* the walker counts the reference's four-layer ``tanh(x @ w)`` program as
  ``analyze_hlo`` does (2·8·64·64·4), and a windowed flash call as 4·dh·b·h
  flops per visible pair;
* on reduced prefills at t = 128 (the reference's single-chunk path, its
  flash branch off) the walker's flops equal ``analyze_hlo``'s once the
  conventions are reconciled: a flash call counts its visible pairs where
  the reference's masked jnp attention counts the dense t², and on the CPU
  ``ragged_dot`` lowers densely (each routed row against every expert), E
  times the grouped product; nothing else is left (0 flops of residue);
* a ``meta`` run and a real CPU run of one reduced train step (an abstract
  (1, 1) mesh against a gloo group of one) count the same flops and bytes,
  and the cross-check equals a ``FlopCounterMode``'s total;
* over 8 gloo ranks of a (4, 2) mesh, each transport's train step records
  the same collectives as the abstract (4, 2) mesh at the rank's
  coordinates; the abstract mesh refuses a real tensor; ``ragged_shmap``
  (forward and mesh prefill) equals the reference's ``impl="ragged"``
  forward within its own tolerance (atol 2e-4, rtol 2e-3,
  ``tests/test_perf_variants.py``);
* the dry-run and profile CLIs print the reference's lines.

The 8 ranks (``tests/tools_ranks_worker.py``, JAX-free, forked from one
server that imported torch) cost ~9 s of wall time alone; the rest ~25 s.
"""
import multiprocessing
import os

import test_torch_harness  # noqa: F401  (jax.core alias before repro)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.launch import roofline as ref_rf
from repro.launch.hlocost import analyze_hlo
from repro.launch.mesh import make_host_mesh
from repro.launch.specs import input_specs as ref_input_specs
from repro.launch.steps import build_prefill_step as ref_prefill_step
from repro.models.model import forward as ref_forward
from repro.models.model import init_lm as ref_init_lm
from repro_torch import configs
from repro_torch.configs.base import FedConfig, ShapeConfig
from repro_torch.kernels import build
from repro_torch.kernels import exchange as kx
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.grouped_mm import grouped_mm
from repro_torch.kernels import hadamard as hd
from repro_torch.kernels import lattice_quant as lq
from repro_torch.launch import dryrun, profile_pair
from repro_torch.launch import roofline as rf
from repro_torch.launch.hlocost import CostWalker, top_contributors
from repro_torch.launch.mesh import make_abstract_mesh, make_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import (build_train_step, init_train_state,
                                      shard_train_state)
from tools_ranks_worker import (MESH, MOE_TOKENS, RANKS, TRAIN_ARCH,
                                TRAIN_FED, TRAIN_SHAPE, TRANSPORTS,
                                moe_config, run_rank)


def _ref_skip_reason():
    """The reference's ``shape_skip_reason``; its module forces 512 host
    devices through XLA_FLAGS on import, so the variable is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import shape_skip_reason
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return shape_skip_reason


ARCHS = configs.list_archs()
HLO_ARCHS = ("llama3.2-1b", "gemma2-2b", "mamba2-370m", "deepseek-v2-236b")
HLO_B, HLO_T = 2, 128


def _layout(specs):
    return [(s.kind, s.attn, s.window, s.mlp, s.use_rope, s.rope_theta)
            for s in specs]


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_long_variant_match_reference(arch):
    assert {k: tuple(v.__dict__.values()) for k, v in configs.SHAPES.items()
            } == {k: tuple(v.__dict__.values())
                  for k, v in ref_configs.SHAPES.items()}
    for get in ("get_config", "get_reduced"):
        ref, port = (getattr(m, get)(arch) for m in (ref_configs, configs))
        for f in ("long_500k_ok", "long_ctx_window", "long_500k_note"):
            assert getattr(port, f) == getattr(ref, f), (get, f)
        rl, pl = ref.with_long_variant(), port.with_long_variant()
        assert _layout(pl.schedule) == _layout(rl.schedule)
        assert _layout(pl.prefix) == _layout(rl.prefix)
    skip = _ref_skip_reason()
    for name in configs.SHAPES:
        port_cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(
            arch)
        assert dryrun.shape_skip_reason(port_cfg, configs.SHAPES[name]) == \
            skip(ref_cfg, ref_configs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert rf.active_params(cfg) == ref_rf.active_params(rcfg)
    for name in configs.SHAPES:
        for n_slots in (1, 16):
            got = rf.model_flops(cfg, configs.SHAPES[name], 2, n_slots)
            want = ref_rf.model_flops(rcfg, ref_configs.SHAPES[name], 2,
                                      n_slots)
            assert abs(got - want) <= 1e-12 * want, (name, n_slots)


def test_roofline_terms_and_bottleneck():
    """The reference's test at the H100's peaks."""
    t = rf.roofline(989e12, 0.0, {})
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert t["bottleneck"] == "compute"
    t = rf.roofline(0.0, 0.0, {"all-reduce": {"bytes": 450e9, "count": 1}})
    assert abs(t["collective_s"] - 2.0) < 1e-9  # ring factor 2
    assert t["bottleneck"] == "collective"
    t = rf.roofline(0.0, 3.35e12, {"all-gather": {"bytes": 450e9,
                                                  "count": 1}})
    assert abs(t["memory_s"] - 1.0) < 1e-9 and t["bottleneck"] == "memory"


def test_walker_counts_the_reference_tanh_program():
    def body(x, w):
        return jnp.tanh(x @ w), None
    text = jax.jit(lambda x, w: jax.lax.scan(body, x, w)[0]).lower(
        jnp.ones((8, 64)), jnp.zeros((4, 64, 64))).compile().as_text()
    want = analyze_hlo(text)["flops"]
    assert want == 2 * 8 * 64 * 64 * 4
    for dev in ("meta", "cpu"):
        x = torch.ones((8, 64), device=dev)
        ws = torch.zeros((4, 64, 64), device=dev)
        w = CostWalker()
        with w:
            for i in range(4):
                x = torch.tanh(x @ ws[i])
        assert w.flops == w.gemm_flops == w.flop_counter() == want
        # each layer reads x and w and writes x @ w, then tanh reads and
        # writes it: (2·8·64 + 64·64) + 2·8·64 floats
        assert w.bytes == 4 * 4 * (2 * 8 * 64 + 64 * 64 + 2 * 8 * 64)


def test_walker_counts_a_flash_call_as_its_visible_pairs():
    b, t, h, kv, dh, window = 2, 256, 4, 2, 32, 96
    mask = np.tril(np.ones((t, t), bool)) & ~np.tril(np.ones((t, t), bool),
                                                     -window)
    want = 4 * dh * b * h * int(mask.sum())
    assert fa.visible_pairs(t, t, True, window) == int(mask.sum())
    for dev in ("meta", "cpu"):
        q = torch.zeros((b, t, h, dh), device=dev)
        k = torch.zeros((b, t, kv, dh), device=dev)
        w = CostWalker()
        with w:
            out = fa.flash_attention(q, k, k, window=window)
        assert out.shape == q.shape and out.device.type == dev
        assert w.kernels == {"flash_attention": 1}
        assert w.flops == w.kernel_flops == want and w.gemm_flops == 0
        assert w.bytes == 4 * (2 * q.numel() + 2 * k.numel())
        # the plain version ran muted on the CPU; nothing ran on meta
        assert (w.muted_gemm_flops > 0) == (dev == "cpu")
    assert fa.LAUNCHES["flash_attention"] == 0


def test_kernel_wrappers_meta_branches():
    """Each wrapper takes meta tensors, returns its outputs' shapes and
    dtypes, launches nothing; a mix of meta and real tensors refuses."""
    m, d = 3, 4096
    meta = dict(device="meta")
    x = torch.empty((m, d), **meta)
    sg = torch.empty((d,), **meta)
    g = torch.empty((m,), **meta)
    for fn, got, want in (
            ("fused_rotate", kx.fused_rotate(x, sg), ((m, d), torch.float32)),
            ("fused_encode", kx.fused_encode(x, sg, x, g, pack=2),
             ((m, d // 2), torch.uint8)),
            ("quantize_codes", kx.quantize_codes(x, x, g),
             ((m, d), torch.int32)),
            ("snap_codes", kx.snap_codes(torch.empty((1, d), dtype=torch.int32,
                                                     **meta), x, g),
             ((m, d), torch.float32)),
            ("fused_decode", kx.fused_decode(torch.empty(
                (m, d), dtype=torch.int32, **meta), x[:1], sg, g),
             ((m, d), torch.float32)),
            ("hadamard_blocks", hd.hadamard_blocks(torch.empty(
                (2, 64, 64), dtype=torch.bfloat16, **meta)),
             ((2, 64, 64), torch.float32)),
            ("lattice_encode", lq.lattice_encode(sg, sg, 0.1),
             ((d,), torch.int32)),
            ("lattice_decode", lq.lattice_decode(torch.empty(
                (d,), dtype=torch.int32, **meta), sg, 0.1),
             ((d,), torch.float32))):
        assert (tuple(got.shape), got.dtype) == want, fn
        assert got.device.type == "meta", fn
    y, codes = kx.fused_encode(x, sg, x, g, want_rotated=True)
    assert y.shape == x.shape and codes.dtype == torch.int32
    assert sum(kx.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="meta tensors only together"):
        kx.fused_rotate(x, torch.empty(d))
    assert build.on_meta() is False


def _prefill_walk(arch):
    cfg = configs.get_reduced(arch)
    shape = ShapeConfig("p", HLO_T, HLO_B, "prefill")
    w = dryrun.walk_step(cfg, shape,
                         make_abstract_mesh((1, 1), ("data", "model")),
                         FedConfig())[0]
    return cfg, w


@pytest.mark.parametrize("arch", HLO_ARCHS)
def test_walker_flops_match_reference_hlo(arch):
    rcfg = ref_configs.get_reduced(arch)
    mesh = make_host_mesh(1, 1)
    shape = ref_configs.ShapeConfig("p", HLO_T, HLO_B, "prefill")
    with mesh:
        step, p_spec, (p_sh, b_sh) = ref_prefill_step(rcfg, mesh, shape)
        text = jax.jit(step, in_shardings=(p_sh, b_sh)).lower(
            p_spec, ref_input_specs(rcfg, shape)).compile().as_text()
    want = analyze_hlo(text)["flops"]
    cfg, w = _prefill_walk(arch)
    assert w.flop_counter() == w.gemm_flops + w.muted_gemm_flops
    # flash calls: visible pairs here, the dense t² in the reference
    n_flash = w.kernels.get("flash_attention", 0)
    dense = 4 * cfg.head_dim * HLO_B * cfg.n_heads * HLO_T * HLO_T
    got = w.flops - w.kernel_flops + n_flash * dense
    # ragged_dot on the CPU: every routed row against every expert, where
    # the port's grouped products (kernel flops, taken out above) count
    # each routed row against its own
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = sum(s.mlp == "moe" for s in cfg.schedule) * cfg.n_periods
        grouped = 2 * HLO_B * HLO_T * m.top_k * cfg.d_model * \
            m.d_ff_expert * 3
        assert w.kernels["grouped_mm_fwd"] == 3 * n_moe
        got += n_moe * m.n_experts * grouped
    assert abs(got - want) <= 5e-3 * want, (got, want)
    assert got == want     # the residue after both conventions: none


@pytest.fixture
def gloo_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _cpu_train_walk(mesh, transport):
    cfg, fed = configs.get_reduced(TRAIN_ARCH), FedConfig(**TRAIN_FED)
    shape = ShapeConfig("t", 32, 2, "train")
    step, _, (specs, _) = build_train_step(cfg, fed, mesh, shape,
                                           transport=transport,
                                           device="cpu")
    full = init_train_state(cfg, 0, step.n_slots, device="cpu")
    state = shard_train_state(full.server, full.clients, 0, mesh, specs)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                              dtype=v.dtype)
             for k, v in input_specs(cfg, shape, n_slots=1,
                                     local_steps=2).items()}
    w = CostWalker(mesh)
    with mesh.recording(), w:
        step(state, batch)
    return w, cfg, fed, shape


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_meta_and_cpu_train_steps_count_the_same(transport, gloo_one):
    w_cpu, cfg, fed, shape = _cpu_train_walk(gloo_one, transport)
    abstract = make_abstract_mesh((1, 1), ("data", "model"))
    # a first walk on a device copies the RoPE table there once: a short
    # prefill warms it
    dryrun.walk_step(cfg, ShapeConfig("w", 8, 1, "prefill"), abstract, fed)
    w_meta = dryrun.walk_step(cfg, shape, abstract, fed,
                              transport=transport)[0]
    assert w_meta.flops == w_cpu.flops and w_meta.flops > 0
    assert w_meta.bytes == w_cpu.bytes
    assert w_meta.kernels == w_cpu.kernels
    assert w_meta.collectives() == w_cpu.collectives() == {}


def test_cross_check_equals_flop_counter_mode(gloo_one):
    cfg, fed = configs.get_reduced(TRAIN_ARCH), FedConfig(**TRAIN_FED)
    shape = ShapeConfig("t", 32, 2, "train")
    step, _, (specs, _) = build_train_step(cfg, fed, gloo_one, shape,
                                           device="cpu")
    full = init_train_state(cfg, 0, 1, device="cpu")
    state = shard_train_state(full.server, full.clients, 0, gloo_one, specs)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, shape, n_slots=1,
                                     local_steps=2).items()}
    w, fc = CostWalker(gloo_one), FlopCounterMode(display=False)
    with fc, w:
        step(state, batch)
    assert fc.get_total_flops() == w.flop_counter() == w.gemm_flops


def test_moe_flops_equal_for_any_routing():
    """An abstract MoE prefill ('balanced' groups) counts the flops of a
    real run's routing."""
    cfg = moe_config("ragged")
    shape = ShapeConfig("p", 64, 2, "prefill")
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    w_meta = dryrun.walk_step(cfg, shape, mesh, FedConfig())[0]
    from repro_torch.models.model import forward, init_lm
    params, _ = init_lm(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(0))
    w = CostWalker()
    with torch.no_grad(), w:
        forward(cfg, params, {"tokens": toks})
    assert w.gemm_flops + w.kernel_flops > 0
    # the prefill step adds only the cache's writes and the last logits
    assert w_meta.gemm_flops == w.gemm_flops
    assert w_meta.kernel_flops == w.kernel_flops


@pytest.mark.parametrize("arch,tokens", [("deepseek-v2-236b", 37), ("deepseek-v2-236b", 1),
                                         ("llama4-scout-17b-a16e", 64)])
def test_grouped_products_count_alike_on_meta_and_cpu(arch, tokens):
    """The MoE's three grouped products (``kernels/grouped_mm.py``) walk to
    the same flops and bytes on ``meta`` (offsets unread) as on the CPU
    with a real routing (one token: experts without rows), forward and
    backward (the rows' and every weight's gradient: dgrad and wgrad), each
    launch exactly 2·R·K·N flops, and no slice of a weight zero-filled."""
    from repro_torch.models import moe
    cfg = configs.get_reduced(arch)
    m, d, f = cfg.moe, cfg.d_model, cfg.moe.d_ff_expert
    rows = tokens * m.top_k
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.integers(0, m.n_experts, rows)))
    host = [torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        torch.bfloat16) for s in ((m.n_experts, d, f), (m.n_experts, d, f),
                                  (m.n_experts, f, d), (rows, d))]
    costs = []
    for dev in ("meta", "cpu"):
        *w, xs = (v.to(dev) for v in host)
        offs = moe.group_offsets(ids.to(dev), m.n_experts)
        for grad in (False, True):
            leaves = [v.requires_grad_(grad) for v in (xs, *w)]
            walker = CostWalker(records=True)
            with torch.set_grad_enabled(grad), walker:
                x_, wg, wu, wd = leaves
                h = (torch.nn.functional.silu(grouped_mm(x_, wg, offs))
                     * grouped_mm(x_, wu, offs))
                y = grouped_mm(h, wd, offs)
                if grad:
                    torch.autograd.grad(y.float().sum(), leaves)
            ops = {r[0] for r in walker.records}
            assert "slice_backward" not in ops, ops
            kernels = [r for r in walker.records if r[0].startswith(
                "grouped_mm")]
            assert sorted(r[0] for r in kernels) == sorted(
                ["grouped_mm_fwd"] * 3 + (["grouped_mm_dgrad",
                                           "grouped_mm_wgrad"] * 3
                                          if grad else []))
            assert all(r[2] == 2.0 * rows * d * f for r in kernels), kernels
            costs.append((walker.flops, walker.bytes, walker.kernel_flops))
    assert costs[:2] == costs[2:] and costs[0][0] > 0


def test_abstract_mesh_refuses_real_tensors():
    mesh = make_abstract_mesh((4, 2), ("data", "model"), {"data": 3})
    assert mesh.coords() == {"data": 3, "model": 0}
    x = torch.empty((6, 4), device="meta")
    assert mesh.psum(x, ("data", "model")).shape == (6, 4)
    assert mesh.all_gather(x, "data").shape == (4, 6, 4)
    assert mesh.all_gather_tiled(x, "model", 1).shape == (6, 8)
    assert mesh.psum_scatter(x.reshape(1, 24), "data").shape == (1, 6)
    assert [r["kind"] for r in mesh.records] == [
        "all-reduce", "all-reduce", "all-gather", "all-gather",
        "reduce-scatter"]
    for fn in (lambda t: mesh.psum(t, "data"),
               lambda t: mesh.all_gather(t, "model"),
               lambda t: mesh.psum_scatter(t.reshape(1, 24), "data")):
        with pytest.raises(ValueError, match="meta tensors only"):
            fn(torch.zeros((6, 4)))
    with pytest.raises(ValueError, match="outside the mesh"):
        make_abstract_mesh((4, 2), ("data", "model"), {"model": 2})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tools_ranks")
    cfg = ref_configs.get_reduced("llama4-scout-17b-a16e").replace(
        d_ff=256, vocab_size=512)
    key = jax.random.PRNGKey(0)
    params, _ = ref_init_lm(cfg, key)
    toks = jax.random.randint(key, MOE_TOKENS, 0, cfg.vocab_size)
    np.savez(out / "moe.npz", tokens=np.asarray(toks),
             **{f"p/{k}": np.asarray(v) for k, v in params.items()})
    # the ranks forked from a server that imported torch and the worker
    # once (each spawned rank would import them itself); the reference's
    # forward runs meanwhile
    multiprocessing.set_forkserver_preload(["torch", "tools_ranks_worker"])
    ctx = mp.start_processes(run_rank, args=(RANKS, str(out)),
                             nprocs=RANKS, join=False,
                             start_method="forkserver")
    want = np.asarray(jax.jit(
        lambda p, t: ref_forward(cfg, p, {"tokens": t})[0])(params, toks))
    while not ctx.join():
        pass
    return want, [torch.load(out / f"tools_{r}.pt", weights_only=False)
                  for r in range(RANKS)]


def _renumbered(records):
    """The records with their call ids counted from 0 in order (a mesh
    numbers every call it makes; the ranks' mesh ran earlier steps)."""
    ids = {}
    return [dict(r, call=ids.setdefault(r["call"], len(ids)))
            for r in records]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_abstract_mesh_records_equal_gloo_ranks(transport, ranks):
    cfg, fed = configs.get_reduced(TRAIN_ARCH), FedConfig(**TRAIN_FED)
    for res in (ranks[1][0], ranks[1][-1]):
        mesh = make_abstract_mesh(MESH, ("data", "model"), res["coords"])
        dryrun.walk_step(cfg, TRAIN_SHAPE, mesh, fed, transport=transport)
        assert _renumbered(mesh.records) == _renumbered(
            res["records"][transport]), res["coords"]
        assert mesh.records


def test_ragged_shmap_on_gloo_ranks_matches_reference_ragged(ranks):
    want, ports = ranks
    for res in ports:
        np.testing.assert_allclose(res["moe"]["forward"], want, atol=2e-4,
                                   rtol=2e-3)
        np.testing.assert_allclose(res["moe"]["prefill_last"],
                                   want[:, -1], atol=2e-4, rtol=2e-3)


def test_ragged_shmap_local_steps_equal_ragged_on_gloo_ranks(ranks):
    """Under autograd each model rank's expert-FFN block gets its gradient
    gathered back and the input's summed over 'model': K local steps give
    'ragged''s Y on every rank, within fp32 summation order."""
    for res in ranks[1]:
        got, want = (res["moe_progress"][i] for i in ("ragged_shmap",
                                                       "ragged"))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                       rtol=1e-5, err_msg=k)


def test_dryrun_cli_lines_and_records(tmp_path, capsys):
    ref_skip = _ref_skip_reason()
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "deepseek-v2-236b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[OK]   llama3.2-1b__long_500k__single: "
                               "flops/dev=")
    assert " dom=" in lines[0] and "compute=" in lines[0]
    note = ref_skip(ref_configs.get_config("deepseek-v2-236b"),
                    ref_configs.SHAPES["long_500k"])
    assert lines[1] == (f"[SKIP] deepseek-v2-236b__long_500k__single: "
                        f"{note}")
    import json
    res = json.loads((tmp_path / "llama3.2-1b__long_500k__single.json")
                     .read_text())
    for key in ("flops_per_device", "bytes_per_device", "collectives",
                "memory", "roofline", "model_flops_total",
                "model_flops_per_device", "useful_flops_ratio", "lower_s",
                "compile_s", "flop_counter"):
        assert key in res, key
    assert res["compile_s"] is None and res["n_devices"] == 256
    mem = res["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["generated_code_bytes"] is None
    assert res["flop_counter"]["flops"] == res["flop_counter"]["gemm_flops"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "llama3.2-1b", "--bf16-scores"])
    assert "no counterpart" in capsys.readouterr().err


def test_profile_pair_prints_the_top_records(capsys):
    profile_pair.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                       "--top", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5
    assert all("B  x" in ln and ".py:" in ln for ln in lines)
    cfg, w = _prefill_walk("llama3.2-1b")
    assert top_contributors(w) == []    # a walk without records
