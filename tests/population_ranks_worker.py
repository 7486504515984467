"""The port's side of ``tests/test_torch_population_mesh.py``: the cases
and the body of one gloo rank. Imports neither JAX nor the reference, so
each of the 4 spawned processes loads only torch and the port.

Each rank runs, on a split population store over ``client_mesh()`` (4
ranks, n = 16: 4 clients' rows a rank):

* every case of :data:`CASES` twice, on the whole store and on the split
  one, from the same seed: the servers, bits and whole rows come back for
  the parent to hold equal (the cases at n = 18, which 4 ranks do not
  divide, keep every row whole on every rank);
* two QuAFL rounds from the reference's state with its draws injected
  (``inj.npz``, written by the parent);
* the prefill step and :data:`SERVE_STEPS` serve steps of each arch of
  :data:`SERVE_ARCHS` on the local (1, 1) mesh and on a (2, 2) mesh over
  the same 4 ranks.
"""
import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedConfig, ShapeConfig
from repro_torch.data.synthetic import make_federated_classification
from repro_torch.fed import make_algorithm, simulate
from repro_torch.fed.population import SplitRow, shard_population, whole_row
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      rank_blocks)
from repro_torch.models.mlp import init_mlp_classifier, mlp_loss_batched
from repro_torch.models.model import init_lm
from repro_torch.utils import interop
from repro_torch.utils.tree import tree_flatten_vector

RANKS = 4
# the reference's own resharding run (tests/test_population.py): n = 16,
# s = 4, gamma_straggler participation, 4 rounds
FED_KW = dict(n_clients=16, s=4, local_steps=2, lr=0.3, bits=8,
              participation="gamma_straggler:strength=1")
BATCH, SEED = 8, 5
# (algorithm, rounds, chunk, registry kwargs, n); at n = 18, which 4
# ranks do not divide, every row stays whole on every rank
CASES = (("quafl", 4, 0, {}, 16),
         ("quafl", 4, 2, {}, 16),
         ("quafl_scaffold", 2, 0, {}, 16),
         ("adaptive_quafl", 2, 0, {}, 16),
         ("fedavg", 2, 0, {}, 16),
         ("compressed_fedavg", 2, 0, {"uplink": "topk_ef:frac=0.25"}, 16),
         ("fedbuff_device", 2, 0, {"buffer_size": 4}, 16),
         ("quafl", 2, 0, {}, 18),
         ("quafl_scaffold", 2, 0, {}, 18),
         ("fedbuff_device", 2, 0, {"buffer_size": 4}, 18))
# the injected rounds: the round parity tests' QuAFL (tests/test_torch_quafl
# .py) under gamma_straggler participation
INJ_FED_KW = dict(n_clients=16, s=4, local_steps=2, lr=0.3, bits=8,
                  swt=10.0, participation="gamma_straggler:strength=1")
INJ_BATCH, INJ_ROUNDS = 16, 2
SERVE_ARCHS = ("gemma2-2b", "mamba2-370m", "deepseek-v2-236b")
SERVE_B, SERVE_T, SERVE_SEQ, SERVE_STEPS = 2, 12, 32, 4


def case_name(case) -> str:
    name, rounds, chunk, _, n = case
    return (f"{name}_{rounds}r" + (f"_chunk{chunk}" if chunk else "")
            + (f"_n{n}" if n != FED_KW["n_clients"] else ""))


def store_of(state):
    """The population store of any of the algorithms' states."""
    for attr in ("base", "inner"):
        if hasattr(state, attr):
            return store_of(getattr(state, attr))
    return state.pop


def _world(n):
    dev = torch.device("cpu")
    part, _ = make_federated_classification(0, n, d=16, n_classes=4,
                                            device=dev)
    g = torch.Generator()
    g.manual_seed(0)
    return part, init_mlp_classifier(g, 16, 32, 4)


def run_case(case, mesh):
    """The case on the whole store and on the split one: servers, bits,
    every row whole, and the split rows' (rows held, n)."""
    name, rounds, chunk, kw, n = case
    part, p0 = _world(n)
    out = {}
    for label, cm in (("whole", None), ("split", mesh)):
        extra = dict(kw, client_mesh=cm) if cm is not None else dict(kw)
        alg = make_algorithm(name, FedConfig(**dict(FED_KW, n_clients=n)),
                             loss_fn=mlp_loss_batched, template=p0,
                             batch_size=BATCH, device="cpu", **extra)
        gen = torch.Generator()
        gen.manual_seed(SEED)
        tr = simulate(alg, p0, part, gen, rounds=rounds, eval_every=0,
                      record_every=1, scan_chunk=chunk)
        pop = store_of(tr.final_state)
        out[label] = {
            "server": tree_flatten_vector(alg.eval_params(tr.final_state)),
            "bits": [(r["bits_up"], r["bits_down"]) for r in tr.rows],
            "rows": {k: whole_row(v) for k, v in pop.rows.items()
                     if not isinstance(v, tuple)},
            "split": {k: (v.block.shape[0], v.n) for k, v in pop.rows.items()
                      if isinstance(v, SplitRow)},
            "engine": tr.engine}
    return out


def injected_rounds(out, mesh):
    """Two QuAFL rounds on the split store from the reference's state,
    with its draws: the servers, clients, last times, bits and the largest
    lattice step either direction used."""
    inp = np.load(f"{out}/inj.npz")
    template = interop.params_from_numpy(
        {k[2:]: inp[k] for k in inp if k.startswith("p/")}, "cpu")
    data = interop.data_from_numpy(
        {k[2:]: inp[k] for k in inp if k.startswith("d/")}, "cpu")
    state = interop.quafl_state_from_numpy(
        server=inp["server"],
        rows={k[2:]: inp[k] for k in inp if k.startswith("r/")},
        t=int(inp["t"]), sim_time=float(inp["sim_time"]),
        bits_up=float(inp["bits_up"]), bits_down=float(inp["bits_down"]),
        srv_dist_est=inp["srv_dist_est"], device="cpu")
    alg = make_algorithm("quafl", FedConfig(**INJ_FED_KW),
                         loss_fn=mlp_loss_batched, template=template,
                         batch_size=INJ_BATCH, device="cpu",
                         client_mesh=mesh)
    state = state._replace(pop=shard_population(state.pop, mesh))
    seen = []
    gammas = alg.pipeline.gammas
    alg.pipeline.gammas = lambda *a, **k: seen.append(gammas(*a, **k)) \
        or seen[-1]
    res = []
    for r in range(INJ_ROUNDS):
        pre = f"draw{r}/"
        draws = {k[len(pre):]: torch.from_numpy(inp[k]) for k in inp
                 if k.startswith(pre)}
        state, m = alg.round(state, data, None, draws=draws)
        res.append({"server": state.server.clone(),
                    "clients": state.clients.clone(),
                    "last_time": state.last_time.clone(),
                    "bits_up": float(state.bits_up),
                    "bits_down": float(state.bits_down),
                    "m_bits_up": float(m["bits_up"]),
                    "m_bits_down": float(m["bits_down"]),
                    "step": max(float(g.max()) for g in seen)})
        seen.clear()
    return res


def serve(arch, mesh):
    """The prefill step and SERVE_STEPS serve steps of reduced ``arch``
    on ``mesh``: the prefill's last logits, the greedy tokens (b, steps
    + 1) and the whole cache after the last step."""
    cfg = get_reduced(arch)
    params, _ = init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (SERVE_B, SERVE_T))).to(torch.int32)
    prefill, _, (p_specs, b_specs) = build_prefill_step(
        cfg, mesh, ShapeConfig("p", SERVE_SEQ, SERVE_B, "prefill"))
    step, _, _, (_, c_specs, t_spec, _) = build_serve_step(
        cfg, mesh, ShapeConfig("d", SERVE_SEQ, SERVE_B, "decode"))
    pb = rank_blocks(params, p_specs, mesh)
    logits, cache = prefill(pb, rank_blocks({"tokens": toks}, b_specs,
                                            mesh))
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out = [tok]
    tok = rank_blocks({"t": tok}, {"t": t_spec}, mesh)["t"]
    for i in range(SERVE_STEPS):
        tok, cache = step(pb, cache, tok, SERVE_T + i)
        out.append(mesh.gather_leaf(tok, t_spec))
    return {"logits": logits, "tokens": torch.cat(out, 1),
            "cache": {k: mesh.gather_leaf(v, c_specs[k])
                      for k, v in cache.items()},
            "coords": mesh.coords()}


def run_rank(rank, world, out):
    import torch.distributed as dist
    from repro_torch.fed import client_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous",
                            rank=rank, world_size=world)
    mesh = client_mesh()
    res = {"mesh": dict(mesh.shape), "rank": mesh.axis_index("clients")}
    for case in CASES:
        res[case_name(case)] = run_case(case, mesh)
    res["injected"] = injected_rounds(out, mesh)
    local = Mesh((1, 1), ("data", "model"))
    grid = make_mesh((2, 2), ("data", "model"))
    res["serve"] = {arch: {"1x1": serve(arch, local),
                           "2x2": serve(arch, grid)}
                    for arch in SERVE_ARCHS}
    torch.save(res, f"{out}/port_{rank}.pt")
    dist.destroy_process_group()
