"""The body of one gloo rank of ``tests/test_torch_analysis.py``'s
divergence cases. Imports neither JAX nor the reference, so the
forkserver the ranks are forked from loads only torch and the port, once.

On a (2, 1) data×model mesh each rank checks:

* ``rank_dependent``: an output declared replicated (spec None) that adds
  the rank's data coordinate — the mutation, which must be caught;
* ``resolved``: the same value summed over the data axis — clean;
* ``sharded``: the rank-dependent value declared along ``data`` — clean;
* ``exchange``: the shard-local exchange of the lattice codec on real
  tensors over the ranks (``analysis/lint.analyze_exchange_cell``), its
  server and ``qerr`` held equal across the data ranks — clean.
"""
import torch
import torch.distributed as dist

# the exchange cell's modules, imported once by the forkserver
import repro_torch.core.exchange_local  # noqa: F401
import repro_torch.launch.steps  # noqa: F401
from repro_torch.analysis.divergence import check_divergence
from repro_torch.analysis.lint import analyze_exchange_cell
from repro_torch.launch.mesh import make_mesh


def run_rank(rank, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world, 1), ("data", "model"))
        x = torch.ones(8) + float(mesh.axis_index("data"))
        res = {
            "rank_dependent": check_divergence({"w": x}, {"w": None}, mesh,
                                               "fixture"),
            "resolved": check_divergence({"w": mesh.psum(x, "data")},
                                         {"w": None}, mesh, "ok"),
            "sharded": check_divergence({"w": x}, {"w": ("data",)}, mesh,
                                        "ok"),
            "exchange": analyze_exchange_cell(
                "lattice:bits=8", "shard_local", d=1 << 12, n=world,
                mesh=mesh)["violations"],
        }
        torch.save({k: [v if isinstance(v, dict) else v.as_dict()
                        for v in vs] for k, vs in res.items()},
                   f"{out}/rank_{rank}.pt")
    finally:
        dist.destroy_process_group()
