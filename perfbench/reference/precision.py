"""Every matrix product of the reference goes through ``Precision``.

``fp32``: plain float32 products (TF32 off).  The two controls compute
the same products in the precision next below what a configuration
states, with every operand rounded as that precision's tensor cores
take it and the sums kept in fp32: ``tf32`` rounds each operand to
TF32's 10-bit mantissa (round to nearest even), ``fp8`` to float8 e4m3
on a per-tensor scale (the operand's largest magnitude at 448).  The
rounding is applied in the backward's products too.
"""
from __future__ import annotations

import torch

MODES = ("fp32", "tf32", "fp8")
E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 on one scale for the whole tensor."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return torch.matmul(rnd(a), rnd(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        ga = torch.matmul(r(g), r(b).transpose(-1, -2))
        gb = torch.matmul(r(a).transpose(-1, -2), r(g))
        return _sum_to(ga, a.shape), _sum_to(gb, b.shape), None


class Precision:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}: one of {MODES}")
        self.mode = mode
        self._round = {"tf32": round_tf32, "fp8": round_fp8}.get(mode)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``torch.matmul(a, b)`` in this precision."""
        if self._round is None:
            return torch.matmul(a, b)
        return _RoundedMatmul.apply(a, b, self._round)
