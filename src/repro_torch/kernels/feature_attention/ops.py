"""Dispatcher for the Eq. (5)-(6) feature pass.

A CUDA tensor always goes to the hand-written kernel (``kernel.py``); a
CPU tensor goes to the plain PyTorch version (``ref.py``).  There is no
size threshold and no fallback: a kernel that fails to build or launch
raises.  ``use_kernel`` (``RunConfig.feature_kernel``) may only confirm
what the device decides — ``None`` lets the device decide, ``True`` on a
CPU tensor or ``False`` on a CUDA tensor raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.feature_attention.kernel import (
    feature_attention_kernel)
from repro_torch.kernels.feature_attention.ref import feature_attention_ref


def feature_attention(w: torch.Tensor, normalize: bool = True, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """ASO-Fed Eq. (5)-(6): row-softmax of |w| times w (norm-preserving by
    default; ``normalize=False`` is the literal equation).

    Accepts any rank >= 1: the trailing axis is the softmax ("column")
    axis, leading axes are flattened into rows (conv kernels: HWIO
    ``(3, 3, 1, C)`` -> ``(9, C)``).
    """
    on_card = w.is_cuda
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(
            f"feature_kernel={use_kernel!r} contradicts the tensor's device "
            f"({w.device}): the CUDA kernel runs exactly on CUDA tensors, "
            "the plain version exactly on CPU tensors (use None)")
    shape = w.shape
    w2 = w.reshape(-1, shape[-1])
    if on_card:
        out = feature_attention_kernel(w2.contiguous(), normalize)
    else:
        out = feature_attention_ref(w2, normalize)
    return out.reshape(shape)
