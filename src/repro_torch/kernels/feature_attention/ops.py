"""Dispatchers for the Eq. (5)-(6) feature pass and for ASO-Fed's fused
sequential server fold.

A CUDA tensor always goes to the hand-written kernel (``kernel.py``); a
CPU tensor goes to the plain PyTorch version (``ref.py``).  There is no
size threshold and no fallback: a kernel that fails to build or launch
raises.  ``use_kernel`` (``RunConfig.feature_kernel``) may only confirm
what the device decides — ``None`` lets the device decide, ``True`` on a
CPU tensor or ``False`` on a CUDA tensor raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.feature_attention.kernel import (
    feature_attention_kernel, feature_fold_kernel)
from repro_torch.kernels.feature_attention.ref import (
    feature_attention_ref, feature_fold_ref)


def _check_device(use_kernel: Optional[bool], t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card; raises where ``use_kernel``
    contradicts that."""
    on_card = t.is_cuda
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(
            f"feature_kernel={use_kernel!r} contradicts the tensor's device "
            f"({t.device}): the CUDA kernel runs exactly on CUDA tensors, "
            "the plain version exactly on CPU tensors (use None)")
    return on_card


def feature_attention(w: torch.Tensor, normalize: bool = True, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """ASO-Fed Eq. (5)-(6): row-softmax of |w| times w (norm-preserving by
    default; ``normalize=False`` is the literal equation).

    Accepts any rank >= 1: the trailing axis is the softmax ("column")
    axis, leading axes are flattened into rows (conv kernels: HWIO
    ``(3, 3, 1, C)`` -> ``(9, C)``).
    """
    on_card = _check_device(use_kernel, w)
    shape = w.shape
    w2 = w.reshape(-1, shape[-1])
    if on_card:
        out = feature_attention_kernel(w2.contiguous(), normalize)
    else:
        out = feature_attention_ref(w2, normalize)
    return out.reshape(shape)


def feature_fold(w: Dict[str, torch.Tensor], deltas: Dict[str, torch.Tensor],
                 first: str, n: torch.Tensor, idx: torch.Tensor,
                 n_vis: torch.Tensor, n_real: int, normalize: bool = True, *,
                 use_kernel: Optional[bool] = None,
                 reps: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            Dict[str, torch.Tensor]]:
    """ASO-Fed's sequential server fold of one tick (Eq. 4 on every leaf,
    then Eq. 5-6 on ``w[first]``, per arrival in order): (w', n',
    received), received stacked ``(S, ...)`` per leaf.

    ``w``: the server's flat dict of fp32 leaves; ``deltas``: the uploads,
    ``(S, *leaf.shape)``; ``n``: the counts; ``idx`` / ``n_vis``: ``(S,)``;
    the first ``n_real`` slots are real.  ``reps``: None, or each slot's
    fold count as an ``(S,)`` int32 tensor on the fold's device (0 skips
    the slot, 1 folds it, 2 folds it twice: the chaos layer's admission
    and duplicate delivery), read by the kernel from device memory, so
    the host never waits on the admission decision.  On the card one
    launch of the fused kernel; on the CPU the plain per-arrival loop
    (``feature_fold_ref``).  ``use_kernel`` as in
    :func:`feature_attention`."""
    on_card = _check_device(use_kernel, w[first])
    if any(t.dtype != torch.float32 for t in (*w.values(),
                                              *deltas.values(), n, n_vis)):
        raise ValueError("feature_fold folds fp32 state only (the engine's "
                         "state dtype)")
    S = deltas[first].shape[0]
    if not 1 <= n_real <= S:
        raise ValueError(f"feature_fold folds 1 to S={S} real slots, got "
                         f"n_real={n_real}")
    if reps is not None and (reps.dtype != torch.int32
                             or tuple(reps.shape) != (S,)
                             or reps.device != w[first].device):
        raise ValueError(
            f"feature_fold takes reps as an ({S},) int32 tensor on "
            f"{w[first].device}; got {tuple(reps.shape)} {reps.dtype} on "
            f"{reps.device}")
    if not on_card:
        return feature_fold_ref(w, deltas, first, n, idx, n_vis, n_real,
                                normalize, reps)
    keys = list(w)
    cols = w[first].shape[-1]
    w_out, n_out, rec = feature_fold_kernel(
        [w[k].contiguous() for k in keys],
        [deltas[k].contiguous() for k in keys], keys.index(first),
        w[first].numel() // cols, cols, n, idx, n_vis, n_real, normalize,
        reps)
    return dict(zip(keys, w_out)), n_out, dict(zip(keys, rec))
