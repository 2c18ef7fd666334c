"""Plain PyTorch version of the linear recurrence h_t = a_t * h_{t-1} + b_t.

A sequential fp32 loop over the sequence axis, from a zero carry (or
``h0``), as ``repro.kernels.linear_scan.ref.linear_scan_ref`` is.  The
CPU path of the engine's associative fold runs it; on the card it is the
yardstick the CUDA kernel is held against.  ``a`` may carry a channel
axis of 1, broadcast over ``b``'s channels (the fold's per-arrival
coefficients).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (B, S, C) or (B, S, 1), b: (B, S, C) -> (h (B, S, C),
    h_last (B, C)), both in ``b.dtype``."""
    a32 = a.to(torch.float32)
    b32 = b.to(torch.float32)
    B, S, C = b.shape
    h = (torch.zeros((B, C), dtype=torch.float32, device=b.device)
         if h0 is None else h0.to(torch.float32))
    hs = []
    for s in range(S):
        h = a32[:, s] * h + b32[:, s]
        hs.append(h)
    return torch.stack(hs, dim=1).to(b.dtype), h.to(b.dtype)
