"""Dispatcher for the linear recurrence, and the engine's fold prefix.

A CUDA tensor always goes to the hand-written kernel (``kernel.py``); a
CPU tensor goes to the plain PyTorch version (``ref.py``).  There is no
size threshold and no fallback: a kernel that fails to build or launch
raises.  ``use_kernel`` (``RunConfig.fold_kernel`` for the fold) may only
confirm what the device decides — ``None`` lets the device decide,
``True`` on a CPU tensor or ``False`` on a CUDA tensor raises.

:func:`fold_prefix` maps one tick's affine server-fold stream onto the
recurrence: B=1, S = the tick's bucket, C = one carrier leaf's size, the
(S,) coefficients broadcast over C — one launch per carrier leaf.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.common.pytree import Tree, tree_flatten, tree_unflatten
from repro_torch.kernels.linear_scan.kernel import linear_scan_kernel
from repro_torch.kernels.linear_scan.ref import linear_scan_ref


def _on_card(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    on_card = x.is_cuda
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(
            f"fold_kernel={use_kernel!r} contradicts the tensor's device "
            f"({x.device}): the CUDA kernel runs exactly on CUDA tensors, "
            "the plain version exactly on CPU tensors (use None)")
    return on_card


def _scan(a: torch.Tensor, b: torch.Tensor, on_card: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    if on_card:
        return linear_scan_kernel(a.contiguous(), b.contiguous())
    return linear_scan_ref(a, b)


def linear_scan(a: torch.Tensor, b: torch.Tensor, *,
                use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 from a zero carry.

    ``a`` and ``b`` share a ``(B, S, ...)`` layout (Mamba's ``(B, S,
    d_inner, N)``, RG-LRU's ``(B, S, width)``), flattened to ``C``
    channels.  Returns ``(h, h_last)`` in that layout and ``b.dtype``.
    """
    shape = b.shape
    B, S = shape[0], shape[1]
    h, h_last = _scan(a.reshape(B, S, -1), b.reshape(B, S, -1),
                      _on_card(b, use_kernel))
    return h.reshape(shape), h_last.reshape((B,) + tuple(shape[2:]))


def fold_prefix(a: torch.Tensor, b: Tree, h0: Optional[Tree] = None, *,
                use_kernel: Optional[bool] = None) -> Tree:
    """Inclusive prefix states of an affine fold stream.

    ``a``: (S,) per-arrival coefficients; ``b``: tree of ``(S, ...)``
    leaves; ``h0``: tree matching ``b`` without the leading axis (None =
    zeros).  Returns the tree ``h`` of ``(S, ...)`` states with ``h_s =
    a_s * h_{s-1} + b_s`` seeded at ``h0`` — what the sequential fold
    computes, up to fp reassociation.

    As in ``repro.kernels.linear_scan.ops.fold_prefix``: ``A =
    cumprod(a)`` in fp32, a zero-seeded prefix ``B`` of each leaf, then
    ``h = A * h0 + B``.  Everything is fp32.
    """
    a32 = a.to(torch.float32)
    S = a32.shape[0]
    leaves, treedef = tree_flatten(b)
    on_card = _on_card(a32, use_kernel)
    a3 = a32.reshape(1, S, 1)  # broadcast over every leaf's channels
    out = []
    for x in leaves:
        C = max(1, x.numel() // S)
        h, _ = _scan(a3, x.reshape(1, S, C).to(torch.float32), on_card)
        out.append(h[0].reshape(x.shape))
    if h0 is not None:
        A = torch.cumprod(a32, dim=0)
        out = [A.reshape((S,) + (1,) * (Bl.dim() - 1)) * x.unsqueeze(0) + Bl
               for Bl, x in zip(out, tree_flatten(h0)[0])]
    return tree_unflatten(treedef, out)
