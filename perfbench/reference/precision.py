"""Matrix products of the plain reference in a stated precision.

``float32`` is the reference itself: fp32 products with TF32 off. The lower
precisions serve as the control that the comparison must refuse: the
operands of every product, forward and backward, are rounded to the
format and the products summed in fp32, as the tensor cores do.

* ``tf32``: 10 mantissa bits, round to nearest even.
* ``fp8``: float8 e4m3 after a per-tensor scale that maps the largest
  magnitude to 448.

``bf16`` (operands rounded to bfloat16) is no control but a witness: the
reference computing as a bf16 program does.

:func:`act` rounds an activation where a program that computes in the
configuration's precision holds it in that precision (the residual
stream, norms, projections, attention outputs, logits), and its gradient
in the backward pass: to bf16 in ``bf16`` and in ``fp8``, whose control
is a bf16 program with its products' operands in fp8 (the step a faster
GEMM would take); fp32 and TF32 keep activations in fp32.
"""
from __future__ import annotations

import torch

MODES = ("float32", "tf32", "bf16", "fp8")


def fp32_only() -> None:
    """Turn TF32 off for every fp32 product of this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    # round the 13 low mantissa bits to nearest even, then clear them
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


_ROUND = {"float32": None, "tf32": _tf32, "bf16": _bf16, "fp8": _fp8}
# the format an activation is held in, by mode
_HOLD = {"bf16": _bf16, "fp8": _bf16}


class _Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        r = _ROUND[mode]
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        if r is None:
            return torch.matmul(a, b)
        return torch.matmul(r(a), r(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = _ROUND[ctx.mode] or (lambda t: t)
        ga = torch.matmul(r(g), r(b).transpose(-1, -2))
        gb = torch.matmul(r(a).transpose(-1, -2), r(g))
        # a broadcast operand (one weight for a batch of rows) sums back
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        return ga, gb, None


class _Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _HOLD[mode](x)

    @staticmethod
    def backward(ctx, g):
        return _HOLD[ctx.mode](g), None


def act(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` rounded to the format ``mode`` holds activations in (bf16 for
    ``bf16`` and ``fp8``), forward and backward; unchanged in fp32 and
    TF32."""
    if mode in ("float32", "tf32"):
        return x
    return _Act.apply(x, mode)


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` in fp32 with its operands rounded to ``mode``."""
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}; choose from {MODES}")
    if mode == "float32":
        return torch.matmul(a, b)
    return _Mm.apply(a, b, mode)
