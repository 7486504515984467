"""The mesh serving steps against the JAX reference's: ``launch/specs.py``
(``input_specs``, ``input_axes``, ``abstract_cache``, ``cache_axes``) shape
for shape, dtype for dtype and axis for axis on every ported arch, no
compute; ``build_prefill_step`` and ``build_serve_step`` on the (1, 1)
mesh against the reference's steps jitted on a one-device CPU mesh, with
the reference's weights carried across; and the ``serve_requests`` twin
against the reference's script. The (2, 2) gloo mesh's steps are held to
the (1, 1) result in ``tests/test_torch_population_mesh.py``.

Tolerances (``tests/test_torch_zoo.py``'s for serving): the prefill's
last-position logits within 1e-4 of max |want|, greedy tokens equal.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import npy
from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.launch import specs as ref_specs
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.utils.compat import make_mesh as ref_make_mesh
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.examples import serve_requests
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      rank_blocks)
from repro_torch.utils.interop import lm_params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("gemma2-2b", "mamba2-370m", "deepseek-v2-236b")
LOGIT_TOL = 1e-4
B, T, SEQ, STEPS = 2, 12, 32, 4
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
SHAPES = [("train", 64, 8), ("prefill", 128, 4), ("decode", 256, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced widths gain nothing from intra-op threads, and the suite's
    workers share the machine's cores: one thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", configs.list_archs())
def test_specs_match_reference(arch):
    cfg, rcfg = configs.get_reduced(arch), ref_configs.get_reduced(arch)
    for kind, t, b in SHAPES:
        shape = ShapeConfig(kind, t, b, kind)
        rshape = RefShapeConfig(kind, t, b, kind)
        got = specs.input_specs(cfg, shape, n_slots=2, local_steps=3)
        want = ref_specs.input_specs(rcfg, rshape, n_slots=2, local_steps=3)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape), (arch, kind, k)
            assert _dtype(got[k]) == str(v.dtype), (arch, kind, k)
        assert specs.input_axes(cfg, shape) == ref_specs.input_axes(
            rcfg, rshape)
    assert specs.enc_len_for(ShapeConfig("d", 256, 4, "decode")) == \
        ref_specs.enc_len_for(RefShapeConfig("d", 256, 4, "decode"))
    shape = ShapeConfig("d", 256, 4, "decode")
    cache, axes = specs.abstract_cache(cfg, shape)
    rcache, raxes = ref_specs.abstract_cache(rcfg, RefShapeConfig(
        "d", 256, 4, "decode"))
    assert cache.keys() == rcache.keys() and axes == raxes
    assert specs.cache_axes(cfg) == ref_specs.cache_axes(rcfg) == axes
    for k, v in rcache.items():
        assert tuple(cache[k].shape) == tuple(v.shape), (arch, k)
        assert _dtype(cache[k]) == str(v.dtype), (arch, k)
        assert len(axes[k]) == v.ndim


def test_specs_refuse_encoder_decoder_and_frontends():
    """The encoder-decoder and frontend archs (ROADMAP Queue 1 item 12)
    now have specs, equal to the reference's at each kind of shape: the
    ``frontend`` entries (seq_len//2 frames beside seq_len//2 tokens, or
    the vision tokens before the text), their axes, and the decode cache's
    ``cross/{k,v}`` at ``enc_len_for``; the mesh prefill step takes the
    ``frontend`` batch."""
    for arch in ("seamless-m4t-medium", "llava-next-34b"):
        cfg, rcfg = configs.get_reduced(arch), ref_configs.get_reduced(arch)
        for kind, t, b in SHAPES:
            shape, rshape = (ShapeConfig(kind, t, b, kind),
                             RefShapeConfig(kind, t, b, kind))
            got = specs.input_specs(cfg, shape, n_slots=2, local_steps=3)
            want = ref_specs.input_specs(rcfg, rshape, n_slots=2,
                                         local_steps=3)
            assert got.keys() == want.keys()
            assert ("frontend" in got) == (kind != "decode")
            for k, v in want.items():
                assert tuple(got[k].shape) == tuple(v.shape), (arch, kind, k)
                assert _dtype(got[k]) == str(v.dtype), (arch, kind, k)
            assert specs.input_axes(cfg, shape) == ref_specs.input_axes(
                rcfg, rshape)
            cache, axes = specs.abstract_cache(cfg, shape)
            rcache, raxes = ref_specs.abstract_cache(rcfg, rshape)
            assert axes == raxes == specs.cache_axes(cfg)
            assert {k: tuple(v.shape) for k, v in cache.items()} == {
                k: tuple(v.shape) for k, v in rcache.items()}
            if cfg.encdec:
                assert cache["body/0/cross/k"].shape[2] == \
                    specs.enc_len_for(shape)
        _, _, (_, b_specs) = build_prefill_step(
            cfg, make_mesh((1, 1), ("data", "model")),
            ShapeConfig("p", 64, 2, "prefill"))
        assert sorted(b_specs) == ["frontend", "tokens"]


def _reference(rcfg, rp, toks):
    """The reference's prefill step and STEPS serve steps, jitted on a
    one-device mesh: (last logits, tokens (b, STEPS + 1))."""
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    with mesh:
        pre, _, (p_sh, b_sh) = ref_steps.build_prefill_step(
            rcfg, mesh, RefShapeConfig("p", SEQ, B, "prefill"))
        srv, _, _, shs = ref_steps.build_serve_step(
            rcfg, mesh, RefShapeConfig("d", SEQ, B, "decode"))
        params = {k: jnp.asarray(v) for k, v in rp.items()}
        batch = {"tokens": jnp.asarray(toks)}
        pre_c = jax.jit(pre, in_shardings=(p_sh, b_sh)).lower(
            params, batch).compile(compiler_options=CHEAP)
        logits, cache = pre_c(params, batch)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        srv_c = jax.jit(srv, in_shardings=shs).lower(
            params, cache, tok, jnp.int32(T)).compile(
                compiler_options=CHEAP)
        out = [np.asarray(tok)]
        for i in range(STEPS):
            tok, cache = srv_c(params, cache, tok, jnp.int32(T + i))
            out.append(np.asarray(tok))
    return np.asarray(logits), np.concatenate(out, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    rcfg, cfg = ref_configs.get_reduced(arch), configs.get_reduced(arch)
    rp = jax.jit(lambda k: ref_model.init_lm(rcfg, k)[0])(
        jax.random.PRNGKey(0))
    rp = {k: np.asarray(v) for k, v in rp.items()}
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (B, T),
                                             dtype=np.int32)
    want_logits, want_toks = _reference(rcfg, rp, toks)

    mesh = make_mesh((1, 1), ("data", "model"))
    prefill, spec, (p_specs, b_specs) = build_prefill_step(
        cfg, mesh, ShapeConfig("p", SEQ, B, "prefill"))
    step, _, cache_spec, (_, c_specs, t_spec, pos_spec) = build_serve_step(
        cfg, mesh, ShapeConfig("d", SEQ, B, "decode"))
    assert sorted(spec) == sorted(rp) and pos_spec == ()
    params = rank_blocks(lm_params_from_numpy(rp, "cpu"), p_specs, mesh)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(toks)})
    assert cache.keys() == cache_spec.keys() == c_specs.keys()
    for k, v in cache.items():
        assert v.shape == cache_spec[k].shape, k
    err = np.abs(npy(logits) - want_logits).max()
    assert err <= LOGIT_TOL * np.abs(want_logits).max(), (arch, err)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(STEPS):
        tok, cache = step(params, cache, tok, T + i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        out.append(tok)
    np.testing.assert_array_equal(npy(torch.cat(out, 1)), want_toks)


def _reference_twin():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_requests", ROOT / "examples" / "serve_requests.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text):
    """Each line without its timing: 'N requests, M tokens' and the
    prompt lengths and token counts of the first requests."""
    out = []
    for ln in text.strip().splitlines():
        if " tokens in " in ln:
            out.append(ln.split(" in ")[0])
        else:
            head, toks = ln.split(" -> ")
            out.append((head, len(eval(toks))))
    return out


def test_serve_requests_twin_prints_the_reference_lines(capsys,
                                                        monkeypatch):
    argv = ["--arch", "mamba2-370m", "--requests", "5", "--max-new", "6"]
    done = serve_requests.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert len(done) == 5 and all(len(r.out_tokens) == 6 for r in done)
    monkeypatch.setattr("sys.argv", ["serve_requests.py"] + argv)
    _reference_twin().main()
    want = capsys.readouterr().out
    assert _lines(got) == _lines(want), (got, want)
    assert _lines(got)[0] == "mamba2-370m (reduced): 5 requests, 30 tokens"
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_requests.main(["--arch", "seamless-m4t-medium",
                             "--device", "cpu"])
