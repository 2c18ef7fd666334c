"""Dispatcher for flash attention: model layout in and out.

A CUDA tensor always goes to the hand-written kernel (``kernel.py``),
which reads the model layout directly; a CPU tensor goes to the plain
PyTorch version (``ref.py``) through the kernel layout, as
``repro.kernels.flash_attention.ops`` transposes for its kernel.  There
is no size threshold and no fallback: a kernel that fails to build or
launch raises.  ``use_kernel`` may only confirm what the device decides
— ``None`` lets the device decide, ``True`` on a CPU tensor or ``False``
on a CUDA tensor raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, k_positions: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    contiguous: bool = True,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q: (B, S, KV, G, hd); k/v: (B, S_kv, KV, hd); positions (B, S) /
    (B, S_kv) int.  Returns (B, S, KV, G, hd) in q's dtype.

    ``contiguous`` says the positions are ``arange`` (prefill), which
    lets the kernel skip fully masked KV tiles; it changes no result
    except that of a row whose keys are all masked (see the kernel's
    source).  The plain version attends densely and ignores it.
    """
    on_card = q.is_cuda
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(
            f"use_kernel={use_kernel!r} contradicts the tensor's device "
            f"({q.device}): the CUDA kernel runs exactly on CUDA tensors, "
            "the plain version exactly on CPU tensors (use None)")
    if on_card:
        return flash_attention_kernel(
            q.contiguous(), k.contiguous(), v.contiguous(),
            q_positions.to(torch.int32).contiguous(),
            k_positions.to(torch.int32).contiguous(), causal=causal,
            window=window, contiguous=contiguous)
    B, Sq, KV, G, hd = q.shape
    qk = q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd)
    o = flash_attention_ref(qk, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                            q_positions, k_positions, causal=causal,
                            window=window)
    return o.reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)
