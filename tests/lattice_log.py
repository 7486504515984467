"""Records the lattice encodes and quantizes of the port's ``cuda`` backend
for the parity tests. Imports neither JAX nor the reference, so the rank
processes of ``tests/test_torch_mesh_ranks.py`` load it cheaply."""
import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LatticeLog:
    """Records every lattice encode and quantize of the port's ``cuda``
    backend (the kernels' wrappers; their plain versions on the CPU) while
    installed: kind, inputs, γ, keyword arguments and codes, as numpy.
    ``install()`` returns a function that restores the backend."""

    def __init__(self, calls=None):
        self.calls = [] if calls is None else calls

    def install(self):
        from repro_torch.compression import pipeline
        be = pipeline._REGISTRY["cuda"]

        def encode(x2, signs, u2, gammas, **kw):
            out = be.encode(x2, signs, u2, gammas, **kw)
            codes = out[1] if kw.get("want_rotated") else out
            self.calls.append(dict(kind="encode", x=_np(x2), signs=_np(signs),
                                   u=_np(u2), gam=_np(gammas), kw=kw,
                                   codes=_np(codes)))
            return out

        def quantize(y2, u2, gammas, **kw):
            codes = be.quantize(y2, u2, gammas, **kw)
            self.calls.append(dict(kind="quantize", x=_np(y2), signs=None,
                                   u=_np(u2), gam=_np(gammas), kw=kw,
                                   codes=_np(codes)))
            return codes
        pipeline._REGISTRY["cuda"] = be._replace(encode=encode,
                                                 quantize=quantize)

        def restore():
            pipeline._REGISTRY["cuda"] = be
        return restore

    def by_leaf(self, leaves):
        """The calls of one exchange grouped by leaf (sorted order): each
        leaf's uplink encode, its reduce-scatter quantize if any, its
        downlink encode; as ``{leaf: {"up": c, "rs": c or None, "down":
        c}}``."""
        out, group = {}, []
        names = iter(sorted(leaves))
        for c in self.calls:
            group.append(c)
            if sum(g["kind"] == "encode" for g in group) == 2:
                rs = [g for g in group if g["kind"] == "quantize"]
                out[next(names)] = {"up": group[0], "down": group[-1],
                                    "rs": rs[0] if rs else None}
                group = []
        assert not group and len(out) == len(leaves), (len(out), group)
        return out
