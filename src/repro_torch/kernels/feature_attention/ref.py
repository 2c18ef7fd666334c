"""Plain PyTorch version of the ASO-Fed Eq. (5)-(6) feature pass.

    alpha[i, j] = exp(|w[i, j]|) / sum_j exp(|w[i, j]|)   (row softmax of |w|)
    w[i, j]    <- alpha[i, j] * w[i, j]

With ``normalize=True`` (default) each row's L2 norm is restored after
the reweighting (the paper's "combined with weight normalization"; see
``repro.kernels.feature_attention.ref`` for why).  Computed in fp32
whatever the input dtype, cast back at the end.  The CPU path of the
engine runs this; on the card it is the yardstick the CUDA kernel is
held against.

:func:`feature_fold_ref` is the plain version of the fused kernel: ASO-Fed's
sequential server fold of one tick, one arrival at a time.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.pytree import tree_axpy, tree_map


def feature_attention_ref(w: torch.Tensor, normalize: bool = True
                          ) -> torch.Tensor:
    """w: (rows, cols) -> reweighted w, same shape and dtype."""
    w32 = w.to(torch.float32)
    a = w32.abs()
    a = a - a.amax(dim=-1, keepdim=True)  # stable softmax
    e = torch.exp(a)
    alpha = e / e.sum(dim=-1, keepdim=True)
    out = alpha * w32
    if normalize:
        norm_in = torch.sqrt((w32 * w32).sum(dim=-1, keepdim=True))
        norm_out = torch.sqrt((out * out).sum(dim=-1, keepdim=True))
        out = out * (norm_in / torch.clamp(norm_out, min=1e-12))
    return out.to(w.dtype)


def feature_fold_ref(w: Dict[str, torch.Tensor],
                     deltas: Dict[str, torch.Tensor], first: str,
                     n: torch.Tensor, idx: torch.Tensor, n_vis: torch.Tensor,
                     n_real: int, normalize: bool = True
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                Dict[str, torch.Tensor]]:
    """ASO-Fed's sequential fold of a tick's first ``n_real`` slots, in
    arrival order: per arrival the count update, the weight n'_k / N',
    the Eq. (4) axpy on every leaf and the feature pass on ``w[first]``
    (rows over its last axis).  The same torch ops in the same order as
    ``AsoFedStrategy.build_fold`` folded one arrival at a time, with the
    received models stacked ``(S, ...)`` and slots past ``n_real`` a copy
    of the last real one.  Returns (w', n', received)."""
    received = []
    for s in range(n_real):
        n = n.index_copy(0, idx[s].reshape(1), n_vis[s].reshape(1))
        weight = n_vis[s] / torch.clamp(n.sum(), min=1e-9)  # n'_k / N'
        w = tree_axpy(-weight, tree_map(lambda u: u[s], deltas), w)
        shape = w[first].shape
        w[first] = feature_attention_ref(w[first].reshape(-1, shape[-1]),
                                         normalize).reshape(shape)
        received.append(w)
    pad = (received[-1],) * (deltas[first].shape[0] - n_real)
    return w, n, tree_map(lambda *rs: torch.stack(rs), *received, *pad)
