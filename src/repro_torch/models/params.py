"""Parameter construction (port of ``repro.models.params``).

Params are a FLAT dict keyed by '/'-joined paths, exactly the reference's
keys (``embed/tok``, ``body/{j}/attn/wq``, ...), so weights carry across
key for key. Layer stacks of the body carry a leading ``layers`` axis,
created by :meth:`SubCtx.stacked`. Each path draws from its own
``torch.Generator``, seeded by :func:`repro_torch.utils.tree.fold_in_str`;
the draws differ from the reference's, and tests carry the reference's
weights across with :mod:`repro_torch.utils.interop`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import fold_in_str

Axes = Tuple[Optional[str], ...]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# uniform inits of the Mamba block: (low, high, map of the draw)
_UNIFORM = {
    # dt_bias: softplus^-1(U(1e-3, 1e-1))
    "uniform_dt": (1e-3, 1e-1, lambda u: torch.log(torch.expm1(u))),
    # A_log: log of A in [1, 16]
    "a_log": (1.0, 16.0, torch.log),
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


def normal_param(generator: torch.Generator, shape: Tuple[int, ...],
                 scale: float = None) -> torch.Tensor:
    """fp32 normal init scaled by 1/sqrt(fan_in), fan_in = shape[-2] (1 for
    vectors), on the generator's device."""
    if scale is None:
        fan_in = shape[-2] if len(shape) > 1 else 1
        scale = 1.0 / np.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return x * float(scale)


class Ctx:
    """Records (path -> tensor) and (path -> logical axes)."""

    def __init__(self, seed: int, param_dtype: str, device):
        self.seed = seed
        self.device = torch.device(device)
        self.param_dtype = torch_dtype(param_dtype)
        self.params: Dict[str, torch.Tensor] = {}
        self.axes: Dict[str, Axes] = {}

    def _make(self, path: str, shape, init: str, scale):
        if self.device.type == "meta":    # shapes only (abstract_lm)
            return torch.empty(tuple(shape), dtype=self.param_dtype,
                               device=self.device)
        if init == "zeros":
            return torch.zeros(tuple(shape), dtype=self.param_dtype,
                               device=self.device)
        if init == "ones":
            return torch.ones(tuple(shape), dtype=self.param_dtype,
                              device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in_str(self.seed, path))
        if init == "normal":
            return normal_param(gen, tuple(shape), scale).to(self.param_dtype)
        if init in _UNIFORM:
            lo, hi, f = _UNIFORM[init]
            u = torch.rand(tuple(shape), generator=gen, device=self.device,
                           dtype=torch.float32)
            return f(u * (hi - lo) + lo).to(self.param_dtype)
        raise ValueError(f"unknown init {init!r}")

    def add(self, path: str, shape, axes, init: str, scale):
        if len(shape) != len(axes):
            raise ValueError(f"{path}: shape {shape} vs axes {axes}")
        if path in self.params:
            raise ValueError(f"duplicate param {path}")
        self.axes[path] = tuple(axes)
        self.params[path] = self._make(path, shape, init, scale)
        return self.params[path]

    def sub(self, prefix: str) -> SubCtx:
        return SubCtx(self, prefix, stack=0)


class SubCtx:
    """Prefixes paths; optionally prepends a stacked 'layers' dim of size n."""

    def __init__(self, parent: Ctx, prefix: str, stack: int = 0):
        self._p = parent
        self._prefix = prefix
        self._stack = stack

    def param(self, path, shape, axes, init="normal", scale=None):
        full = f"{self._prefix}/{path}" if self._prefix else path
        if self._stack:
            shape = (self._stack,) + tuple(shape)
            axes = ("layers",) + tuple(axes)
        return self._p.add(full, tuple(shape), axes, init, scale)

    def sub(self, prefix: str) -> SubCtx:
        pre = f"{self._prefix}/{prefix}" if self._prefix else prefix
        return SubCtx(self._p, pre, stack=self._stack)

    def stacked(self, prefix: str, n: int) -> SubCtx:
        if self._stack:
            raise ValueError("nested stacking unsupported")
        pre = f"{self._prefix}/{prefix}" if self._prefix else prefix
        return SubCtx(self._p, pre, stack=n)


def subtree(params: Dict[str, torch.Tensor], prefix: str
            ) -> Dict[str, torch.Tensor]:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def has_subtree(params: Dict[str, torch.Tensor], prefix: str) -> bool:
    pre = prefix + "/"
    return any(k.startswith(pre) for k in params)
