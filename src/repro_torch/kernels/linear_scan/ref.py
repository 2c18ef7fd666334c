"""Plain PyTorch version of the linear recurrence h_t = a_t * h_{t-1} + b_t.

A sequential fp32 loop over the sequence axis, from a zero carry (or
``h0``), as ``repro.kernels.linear_scan.ref.linear_scan_ref`` is.  The
CPU path of the engine's associative fold runs it; on the card it is the
yardstick the CUDA kernel is held against.  ``a`` may carry a channel
axis of 1, broadcast over ``b``'s channels (the fold's per-arrival
coefficients).  ``linear_scan_backward_ref`` is the plain reverse loop
of the recurrence, what the CPU path of ``ops.linear_scan``'s autograd
Function runs and what the backward kernel is held against.

Both compute in fp32 (in fp64 for fp64 inputs, which gradient checks
use).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (B, S, C) or (B, S, 1), b: (B, S, C) -> (h (B, S, C),
    h_last (B, C)), both in ``b.dtype``."""
    dt = _compute_dtype(b)
    a32 = a.to(dt)
    b32 = b.to(dt)
    B, S, C = b.shape
    h = (torch.zeros((B, C), dtype=dt, device=b.device)
         if h0 is None else h0.to(dt))
    hs = []
    for s in range(S):
        h = a32[:, s] * h + b32[:, s]
        hs.append(h)
    return torch.stack(hs, dim=1).to(b.dtype), h.to(b.dtype)


def linear_scan_backward_ref(a: torch.Tensor, h: torch.Tensor,
                             dh: torch.Tensor,
                             dh_last: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, the forward's h and its gradient dh, all (B, S, C), dh_last
    (B, C) (None: zero) -> (da, db), both (B, S, C), from the zero carry:
    ``g[S-1] = dh[S-1] + dh_last``, ``g[t] = dh[t] + a[t+1] * g[t+1]``,
    ``db[t] = g[t]``, ``da[t] = g[t] * h[t-1]`` with ``h[-1] = 0``.  Each
    product and sum is rounded as autograd of ``linear_scan_ref`` rounds
    it, so in fp32 the two agree bit for bit."""
    dt = _compute_dtype(h)
    a32, h32, dh32 = a.to(dt), h.to(dt), dh.to(dt)
    B, S, C = h.shape
    da = torch.empty((B, S, C), dtype=dt, device=h.device)
    db = torch.empty((B, S, C), dtype=dt, device=h.device)
    g = None
    for t in range(S - 1, -1, -1):
        if g is None:
            g = dh32[:, t] if dh_last is None else dh32[:, t] + dh_last.to(dt)
        else:
            g = dh32[:, t] + g * a32[:, t + 1]
        db[:, t] = g
        da[:, t] = g * (h32[:, t - 1] if t else torch.zeros_like(g))
    return da, db
