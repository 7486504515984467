"""The port's side of ``tests/test_torch_mesh_ranks.py``: the cases and
the body of one gloo rank. Imports neither JAX nor the reference, so each
of the 8 spawned processes loads only torch and the port.

A case is (mesh shape, axis names, fed mode, transport, whole, alone):
``whole`` holds the whole step against the reference's, ``alone`` the
shard-local exchange alone on given Ys. The reference compiles one program
for each, so each is run where it adds a check: the whole step once a
family and mode (the local steps are the same for every transport), the
exchange alone for each shard-local client sum.
"""
import numpy as np
import torch

from lattice_log import LatticeLog
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FedConfig, ShapeConfig
from repro_torch.launch.steps import TrainStep

ARCH = "llama3.2-1b"
K, B, SEQ, LR = 2, 2, 16, 0.05
DP = ((4, 2), ("data", "model"), "client_dp")
CASES = [DP + ("dequant_psum", True, False),
         DP + ("code_allgather", True, False),
         DP + ("shard_local", True, True),
         DP + ("shard_local_codes", True, True),
         DP + ("shard_local_rs", False, True),
         ((2, 2, 2), ("pod", "data", "model"), "cohort", "shard_local", True,
          False)]
SHARD_LOCAL = ("shard_local", "shard_local_codes", "shard_local_rs")
# the reference runs one program a family: its code all-gathers compute
# the same aggregate as the psums they stand beside (its own pins,
# tests/test_distributed.py), from the same inputs
REFERENCE_OF = {"code_allgather": "dequant_psum",
                "shard_local_codes": "shard_local"}


def case_name(case) -> str:
    shape, _, mode, tr = case[:4]
    return f"{'x'.join(map(str, shape))}_{mode}_{tr}"


def reference_name(case) -> str:
    """The case whose reference program serves ``case``."""
    return case_name(case[:3] + (REFERENCE_OF.get(case[3], case[3]),))


def make_step(case, mesh) -> TrainStep:
    shape, _, mode, tr = case[:4]
    fed = FedConfig(local_steps=K, lr=LR, bits=8, transport=tr)
    return TrainStep(get_reduced(ARCH), fed, mesh,
                     ShapeConfig("t", SEQ, B * shape[0], "train"),
                     fed_mode=mode, transport=tr, device="cpu")


def run_rank(rank, world, out):
    """One port rank: each case's whole step with the reference's draws on
    the reference's inputs, its exchange alone on given Ys, and the
    client_dp shard-local family's step with the port's own streams. The
    encodes are recorded; the parent counts their boundary places."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import shard_train_state
    torch.set_num_threads(1)
    log = LatticeLog()
    log.install()
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous",
                            rank=rank, world_size=world)
    res, meshes = {}, {}
    for case in CASES:
        shape, axes, mode, tr, whole, alone = case
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, axes)
        mesh = meshes[shape]
        step = make_step(case, mesh)
        inp = np.load(f"{out}/in_{case_name(case)}.npz")
        srv = {k[4:]: torch.from_numpy(inp[k]) for k in inp
               if k.startswith("srv/")}
        cl = {k[3:]: torch.from_numpy(inp[k]) for k in inp
              if k.startswith("cl/")}
        state = shard_train_state(srv, cl, 0, mesh, step.specs)
        toks = torch.from_numpy(inp["toks"]).long()
        entry = {"coords": mesh.coords()}
        if whole:
            draws = torch.load(f"{out}/draws_{case_name(case)}_{rank}.pt",
                               weights_only=False)
            log.calls.clear()
            st2, m = step(state, {"tokens": toks}, None, draws)
            entry.update(server=st2.server, clients=st2.clients,
                         qerr=float(m["quant_err_sq"]),
                         h_mean=float(m["h_steps_mean"]),
                         calls=list(log.calls))
        if alone:
            ci = mesh.axis_index(step.client_axis)
            ys = {k[3:]: torch.from_numpy(inp[k][ci]) for k in inp
                  if k.startswith("ys/")}
            exd = torch.load(f"{out}/exdraws_{case_name(case)}_{rank}.pt",
                             weights_only=False)
            log.calls.clear()
            entry["exchange"] = step.exchange(state, ys, exd)
            entry["excalls"] = list(log.calls)
        if mode == "client_dp" and tr in SHARD_LOCAL:
            g = torch.Generator()
            g.manual_seed(11)
            entry["own"] = step(state, {"tokens": toks}, g)[0]
        res[case_name(case)] = entry
    torch.save(res, f"{out}/port_{rank}.pt")
    dist.destroy_process_group()
