"""Plain PyTorch version of the ASO-Fed Eq. (5)-(6) feature pass.

    alpha[i, j] = exp(|w[i, j]|) / sum_j exp(|w[i, j]|)   (row softmax of |w|)
    w[i, j]    <- alpha[i, j] * w[i, j]

With ``normalize=True`` (default) each row's L2 norm is restored after
the reweighting (the paper's "combined with weight normalization"; see
``repro.kernels.feature_attention.ref`` for why).  Computed in fp32
whatever the input dtype, cast back at the end.  The CPU path of the
engine runs this; on the card it is the yardstick the CUDA kernel is
held against.
"""
from __future__ import annotations

import torch


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
