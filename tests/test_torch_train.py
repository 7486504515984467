"""Federated LM training in the port (``repro_torch.launch.train``, the
per-client ``batch_fn`` protocol of every registry algorithm, the LM token
task and checkpoints) against the JAX reference at reduced widths.

Inputs are made from numpy seeds or taken from the reference and carried
across; the reference's draws (cohort, H-steps, minibatch rows, signs,
rounding noise, message keys) are injected through
``tests/test_torch_harness.py``. Tolerances:

* tokens: equal, except where the uniform draw lies within 4 ulps of a
  Zipf CDF boundary (the CDF's cumulative sum may round differently in
  XLA and torch); the places are counted;
* gradients: fp32, max |Δ| ≤ 1e-4 · max |g| (two layers of reduced
  widths, fp32 throughout);
* rounds: the server and every client within one lattice step (the
  largest γ of the round's messages: a code may flip by one at a rounding
  boundary), or 1e-5 · max |x| where nothing is quantized; bits equal to
  the exact integers (the reference's fp32 counter rounds at LM sizes).
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from test_torch_harness import (StepLog, message_key, npy,
                                reference_fedavg_draws,
                                reference_round_draws, tt, _batch_idx)
from test_torch_lm import reference_lm
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs.base import FedConfig as RefFedConfig
from repro.data import synthetic as ref_synth
from repro.fed.registry import make_algorithm as ref_make_algorithm
from repro.models import model as ref_model
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.compression.rotation import pad_len
from repro_torch.configs.base import FedConfig
from repro_torch.data import synthetic
from repro_torch.fed import fedbuff_completion_table, make_algorithm
from repro_torch.launch import train
from repro_torch.models import model
from repro_torch.utils.tree import tree_flatten_vector, tree_size

ARCH = "llama3.2-1b"
N, S, K, B, POOL, SEQ, LR = 3, 2, 2, 2, 8, 24, 0.05
GRAD_TOL, PLAIN_TOL = 1e-4, 1e-5


def _fed(cls, **kw):
    base = dict(n_clients=N, s=S, local_steps=K, lr=LR, bits=8)
    return cls(**{**base, **kw})


def _world(seed=0):
    """The reference's LM, its token task, and both carried to the port."""
    rcfg, cfg, rp, pp = reference_lm(ARCH, seed)
    data, batch_fn = ref_synth.federated_token_task(seed, N, POOL, B, SEQ,
                                                    cfg.vocab_size)
    return (rcfg, cfg, {k: jax.numpy.asarray(v) for k, v in rp.items()},
            pp, data, batch_fn, {"tokens": tt(data["tokens"])})


def _algs(name, **kw):
    rcfg, cfg, rp, pp, rdata, rbatch, pdata = _world()
    ref = ref_make_algorithm(name, _fed(RefFedConfig), loss_fn=partial(
        ref_model.lm_loss, rcfg), template=rp, batch_fn=rbatch, **kw)
    port = make_algorithm(name, _fed(FedConfig), loss_fn=partial(
        model.lm_loss, cfg), template=train.shape_template(pp),
        batch_fn=synthetic.token_batch, batch_size=B, device="cpu", **kw)
    return ref, port, rp, pp, rdata, pdata


def _lattice_bits(d, bits=8):
    return pad_len(d) * bits + 32


def _near_boundary(u, cdf, ulps=4):
    """Whether each u lies within ``ulps`` of some CDF value."""
    i = np.clip(np.searchsorted(cdf, u), 1, len(cdf) - 1)
    gap = np.minimum(np.abs(u - cdf[i]), np.abs(u - cdf[i - 1]))
    return gap <= ulps * np.spacing(np.float32(1.0))


# ---------------------------------------------------------------------------
# the LM token task
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,cid", [(512, 0), (512, 5), (128_256, 1),
                                       (128_256, 6)])
def test_token_stream_matches_reference(vocab, cid):
    """At vocab 128,256 the reference's map overflows int32 for ranks past
    ~21,000 and wraps; the port reproduces the wrapped tokens."""
    key = jax.random.PRNGKey(3 + cid)
    want = np.asarray(ref_synth.lm_token_stream(key, 16, 256, vocab,
                                                client_id=cid))
    u = np.asarray(jax.random.uniform(key, (16, 256)))
    got = npy(synthetic.lm_token_stream(None, 16, 256, vocab, client_id=cid,
                                        u=torch.from_numpy(u)))
    assert got.dtype == np.int32 and got.shape == want.shape
    w = (np.arange(vocab, dtype=np.float32) + 1.0) ** np.float32(-1.2)
    cdf = np.asarray(jax.numpy.cumsum(w) / jax.numpy.sum(w))
    off = got != want
    near = _near_boundary(u, cdf)
    # tokens differ only at CDF boundaries: none at vocab 512, where a
    # rank's CDF step is far above an ulp; at 128,256 the tail's steps are
    # about an ulp of 1, so many u sit near one (85 of 4,096 differ at
    # cid 1 on the CPU)
    assert not np.any(off & ~near), int(off.sum())
    if vocab == 512:
        assert not off.any(), int(off.sum())
    if vocab == 128_256:
        # the overflowing ranks are there, and wrapped as int32 wraps
        ranks = np.searchsorted(cdf, u)
        mult = 1_000_003 % vocab + 2 * cid + 1
        assert np.any(ranks.astype(np.int64) * mult > 2**31 - 1)


def test_token_stream_wraps_as_int32():
    """The map at two inputs whose products overflow int32 (cid 1, vocab
    128,256): the reference gives 114601 and 57007; exact int64 arithmetic
    would give 33961 and 45999."""
    vocab = 128_256
    w = (np.arange(vocab, dtype=np.float32) + 1.0) ** np.float32(-1.2)
    cdf = np.cumsum(w, dtype=np.float64) / np.sum(w, dtype=np.float64)
    # a u strictly inside each rank's CDF interval
    u = torch.tensor([[0.5 * (cdf[r - 1] + cdf[r]) for r in (128_255,
                                                              100_000)]],
                     dtype=torch.float32)
    got = synthetic.lm_token_stream(None, 1, 2, vocab, client_id=1, u=u)
    assert got.tolist() == [[114_601, 57_007]]


def test_federated_token_task_pools_and_rows_match_reference():
    """At vocab 512 (no CDF step near an ulp) the pools are exact."""
    n, pool, batch, seq, vocab = 3, 6, 4, 16, 512
    data, batch_fn = ref_synth.federated_token_task(5, n, pool, batch, seq,
                                                    vocab)
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    u = np.stack([np.asarray(jax.random.uniform(k, (pool, seq)))
                  for k in keys])
    pdata, pbatch = synthetic.federated_token_task(
        5, n, pool, batch, seq, vocab, device="cpu", u=torch.from_numpy(u))
    assert np.array_equal(npy(pdata["tokens"]), np.asarray(data["tokens"]))
    for i in range(n):
        key = jax.random.PRNGKey(40 + i)
        rows = np.asarray(jax.random.randint(key, (batch,), 0, pool))
        cd = {"tokens": data["tokens"][i]}
        want = np.asarray(batch_fn(cd, key)["tokens"])
        got = pbatch({"tokens": pdata["tokens"][i]}, torch.from_numpy(rows))
        assert np.array_equal(npy(got["tokens"]), want)
    # the port's own stream: seeded, int32, in the vocab, non-iid
    a = synthetic.make_federated_tokens(1, 2, 4, 8, 512, device="cpu")
    b = synthetic.make_federated_tokens(1, 2, 4, 8, 512, device="cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 512


# ---------------------------------------------------------------------------
# the LM loss's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b", "olmo-1b"])
@pytest.mark.parametrize("t", [128, 40])
def test_lm_loss_gradient_matches_reference(arch, t):
    """At t = 128 serving would take the flash kernel; under autograd the
    prefill takes the plain branches, as the reference's training does."""
    rcfg, cfg, rp, pp = reference_lm(arch, seed=1)
    toks = np.random.default_rng(t).integers(0, cfg.vocab_size, (2, t)
                                             ).astype(np.int32)
    want_loss, want = jax.value_and_grad(
        lambda p: ref_model.lm_loss(rcfg, p, {"tokens": toks})[0])(
        {k: jax.numpy.asarray(v) for k, v in rp.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    loss, _ = model.lm_loss(cfg, leaves, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, [leaves[k] for k in sorted(leaves)])
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    scale = max(float(np.abs(np.asarray(want[k])).max()) for k in want)
    for k, g in zip(sorted(leaves), grads):
        err = np.abs(npy(g) - np.asarray(want[k])).max()
        assert err <= GRAD_TOL * scale, (arch, t, k, err, scale)


def test_client_grad_equals_flat_autograd():
    """The per-client gradient (autograd on the leaves, copied into the
    flat vector) against autograd through the flat vector itself."""
    from repro_torch.core.local import client_grad
    _, cfg, _, pp = reference_lm(ARCH, seed=2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    flat = tree_flatten_vector(pp)
    loss_fn = partial(model.lm_loss, cfg)
    got = client_grad(loss_fn, train.shape_template(pp), flat,
                      {"tokens": toks})
    v = flat.clone().requires_grad_(True)
    from repro_torch.utils.tree import tree_unflatten_vector
    (want,) = torch.autograd.grad(
        loss_fn(tree_unflatten_vector(pp, v), {"tokens": toks})[0], v)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# rounds against the reference, draws injected
# ---------------------------------------------------------------------------

def _gamma_log(pipeline):
    """Record the γ of every lattice message the pipeline encodes."""
    seen = []
    enc, quant = pipeline.rotate_encode, pipeline.quantize

    def rotate_encode(x2, sg, u2, gammas, **kw):
        seen.append(float(gammas.max()))
        return enc(x2, sg, u2, gammas, **kw)

    def quantize(y2, u2, gammas, wire=None):
        seen.append(float(gammas.max()))
        return quant(y2, u2, gammas, wire)

    pipeline.rotate_encode, pipeline.quantize = rotate_encode, quantize
    return seen


def test_quafl_lm_rounds_match_reference():
    """Three QuAFL rounds of reduced llama3.2-1b, the port's state carried
    on its own, every draw the reference's."""
    ref, port, rp, pp, rdata, pdata = _algs("quafl")
    gammas = _gamma_log(port.pipeline)
    rs, ps = ref.init(rp), port.init(pp)
    g = torch.Generator()
    msg = _lattice_bits(port.d)
    for r in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(11), r)
        draws = reference_round_draws(ref, rs, rdata, key, B)
        ps, pm = port.round(ps, pdata, g,
                            draws={k: tt(v) for k, v in draws.items()})
        rs, _ = ref.round(rs, rdata, key)
        step = max(gammas)
        for mine, theirs in ((ps.server, rs.server),
                             (ps.clients, rs.clients)):
            err = np.abs(npy(mine) - np.asarray(theirs)).max()
            assert err <= step, (r, err, step)
        assert float(pm["bits_up"]) == S * msg
        assert float(pm["bits_down"]) == msg
    assert float(ps.bits_up) == 3 * S * msg
    assert float(ps.bits_down) == 3 * msg


def test_fedavg_lm_rounds_match_reference():
    """Two FedAvg rounds (uncompressed both ways), draws injected."""
    ref, port, rp, pp, rdata, pdata = _algs("fedavg")
    rs, ps = ref.init(rp), port.init(pp)
    g = torch.Generator()
    for r in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(12), r)
        draws = reference_fedavg_draws(ref, rs, rdata, key, B, port)
        ps, pm = port.round(ps, pdata, g, draws=draws)
        rs, _ = ref.round(rs, rdata, key)
        want = np.asarray(rs.server)
        err = np.abs(npy(ps.server) - want).max()
        assert err <= PLAIN_TOL * np.abs(want).max(), (r, err)
        assert float(pm["bits_up"]) == S * 32 * port.d
    assert float(ps.sim_time) == pytest.approx(float(rs.sim_time), rel=1e-6)


def _fedbuff_device_draws(ref, state, key, m, port):
    """The reference ``FedBuffDevice`` round's per-completion keys (seeded
    from the first round's key; the table gives the durations, so no
    duration key is split): minibatch rows and uplink message keys."""
    jkey = state.jkey if bool(state.live) else key
    bidx, kq = [], []
    for _ in range(ref.buffer_size):
        jkey, sub = jax.random.split(jkey)
        bidx.append(_batch_idx(sub, ref.fed.local_steps, B, m))
        jkey, qk = jax.random.split(jkey)
        kq.append(qk)
    return {"batch_idx": tt(np.stack(bidx)),
            "key_up": message_key(port.codec_up, kq, port.d)}


def test_fedbuff_device_lm_flushes_match_reference():
    """Two flushes (Z=2) of ``fedbuff_device`` with a lattice uplink: the
    same completion table on both sides, the reference's keys injected."""
    kw = dict(buffer_size=2, quantize=True, quantizer="lattice")
    ref, port, rp, pp, rdata, pdata = _algs("fedbuff_device", **kw)
    table = fedbuff_completion_table(17, port.lam, K, 8)
    ref = ref_make_algorithm("fedbuff_device", ref.fed,
                             loss_fn=ref.loss_fn, template=ref.template,
                             batch_fn=ref.batch_fn, completion_table=table,
                             **kw)
    port = make_algorithm("fedbuff_device", port.fed, loss_fn=port.loss_fn,
                          template=port.template, batch_fn=port.batch_fn,
                          batch_size=B, device="cpu", completion_table=table,
                          **kw)
    port.codec_up = StepLog(port.codec_up)
    rs, ps = ref.init(rp), port.init(pp)
    g = torch.Generator()
    for r in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(13), r)
        draws = _fedbuff_device_draws(ref, rs, key, POOL, port)
        ps, pm = port.round(ps, pdata, g, draws=draws)
        rs, _ = ref.device_round(rs, rdata, key)
        err = np.abs(npy(ps.server) - np.asarray(rs.server)).max()
        assert err <= max(port.codec_up.steps), (r, err)
        assert float(ps.sim_time) == pytest.approx(float(rs.sim_time),
                                                   rel=1e-6)
        assert float(pm["bits_up"]) == 2 * _lattice_bits(port.d)
        assert float(pm["bits_down"]) == 2 * 32 * port.d


# ---------------------------------------------------------------------------
# the CLI: every registry algorithm, checkpoints
# ---------------------------------------------------------------------------

CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
       "--batch", "2", "--seq", "16", "--pool", "8", "--log-every", "1",
       "--lr", "0.05", "--algo", "quafl"]


def _bits_a_round(name, d, row):
    """The exact bits up and down of one round at n = s = 2, b = 8 (an
    adaptive width of b <= 8 rides 8-bit codes)."""
    width = int(row.get("bits_width", 8))
    msg, full = _lattice_bits(d, 8 if width <= 8 else 16), 32 * d
    return {"quafl": (2 * msg, msg), "adaptive_quafl": (2 * msg, msg),
            "quafl_scaffold": (4 * msg, 2 * msg),
            "fedavg": (2 * full, 2 * full),
            "compressed_fedavg": (2 * _lattice_bits(d), full),
            "fedbuff": (2 * full, 2 * full),
            "fedbuff_device": (2 * full, 2 * full),
            "sequential": (0, 0)}[name]


@pytest.mark.parametrize("name", ["quafl", "fedavg", "compressed_fedavg",
                                  "fedbuff", "fedbuff_device", "sequential",
                                  "quafl_scaffold", "adaptive_quafl"])
def test_every_registry_algorithm_trains_the_lm(name, capsys):
    run = train.main(CLI + ["--algo", name])
    out = capsys.readouterr().out
    rows = run.trace.rows
    assert [r["round"] for r in rows] == [1, 2]
    up = down = 0
    for r in rows:
        d = tree_size(run.alg.eval_params(run.trace.final_state))
        bu, bd = _bits_a_round(name, d, r)
        up, down = up + bu, down + bd
        assert r["bits_up"] == bu and r["bits_down"] == bd, (name, r)
        assert r["bits_up_total"] == up and r["bits_down_total"] == down
        assert np.isfinite(r["server_loss"])
    for field in ("round     1 server_loss=", "sim_t=", "h_mean=", "qerr=",
                  "bits_up=", "bits_down=", "engine=eager us_per_round="):
        assert field in out, (name, field)


def test_scan_chunk_lm_run_equals_eager(capsys):
    eager = train.main(CLI + ["--steps", "4"])
    chunked = train.main(CLI + ["--steps", "4", "--scan-chunk", "2"])
    assert chunked.trace.engine == "scanned"
    for a, b in zip(eager.trace.rows, chunked.trace.rows):
        for k in ("bits_up", "bits_down", "sim_time", "quant_err"):
            assert a[k] == b[k], k
    assert torch.equal(eager.trace.final_state.server,
                       chunked.trace.final_state.server)


def test_mesh_flags_refused_naming_item_11(capsys):
    """The mesh path's flags run now that it is ported (ROADMAP Queue 1
    item 11): ``--algo spmd``, with ``--transport shard_local``, with
    ``--mesh-data 1 --mesh-model 1``; a single process asked for two data
    ranks raises, naming torchrun."""
    spmd = ["--algo", "spmd"]
    for extra in (spmd, spmd + ["--transport", "shard_local"],
                  spmd + ["--mesh-data", "1", "--mesh-model", "1"]):
        run = train.main(CLI + extra)
        assert [r["round"] for r in run.trace.rows] == [1, 2]
        assert all(np.isfinite(r["server_loss"]) for r in run.trace.rows)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train.main(CLI + spmd + ["--mesh-data", "2"])


def test_checkpoints_cross_between_packages(tmp_path, capsys):
    run = train.main(CLI + ["--checkpoint-dir", str(tmp_path / "port")])
    assert latest_step(str(tmp_path / "port")) == 2
    params = run.alg.eval_params(run.trace.final_state)
    # port save -> reference restore
    rcfg = reference_lm(ARCH)[0]
    ref_tmpl, _ = ref_model.init_lm(rcfg, jax.random.PRNGKey(0))
    back = ref_restore(str(tmp_path / "port"), 2, ref_tmpl)
    assert sorted(back) == sorted(params)
    for k in params:
        assert np.array_equal(np.asarray(back[k]), npy(params[k])), k
    # reference save -> port restore (meta template: structure only)
    ref_save(str(tmp_path / "ref"), 7, ref_tmpl, extra={"arch": ARCH})
    got = restore_checkpoint(str(tmp_path / "ref"), 7,
                             train.shape_template(params), device="cpu")
    for k in ref_tmpl:
        assert np.array_equal(npy(got[k]), np.asarray(ref_tmpl[k])), k
    # port save -> port restore
    save_checkpoint(str(tmp_path / "rt"), 3, params)
    rt = restore_checkpoint(str(tmp_path / "rt"), 3, params, device="cpu")
    assert all(torch.equal(rt[k], params[k]) for k in params)
    assert latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# what full width needs of the exchange
# ---------------------------------------------------------------------------

def test_exchange_refuses_what_an_int_cannot_hold():
    """llama3.2-1b's d_pad (75,429 blocks of 16,384) fits the kernels' int
    arguments; gemma2-2b's (about 2.61e9) does not, nor 2^31 messages."""
    from repro_torch.kernels import exchange as kx
    kx.check_launch_ints(2, 1_235_828_736)
    kx.check_launch_ints(1, kx.MAX_D_PAD)
    for m, d_pad in ((1, 2_614_345_728), (1, kx.MAX_D_PAD + 1),
                     (2**31, 16_384)):
        with pytest.raises(ValueError, match="C int"):
            kx.check_launch_ints(m, d_pad)


@pytest.mark.parametrize("n", [1, 16_384, 1_000_003])
def test_int8_sign_draws_equal_the_int64_ones(n):
    """``signs`` draws int8 bits: the same values as an int64 draw, and the
    generator moves on by the same amount."""
    from repro_torch.compression.rotation import signs
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(n)
    g2.manual_seed(n)
    want = (torch.randint(0, 2, (n,), generator=g2) * 2 - 1).to(
        torch.float32)
    assert torch.equal(signs(g1, n), want)
    assert torch.equal(torch.rand(5, generator=g1),
                       torch.rand(5, generator=g2))
