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

``selective_scan_ref`` is the plain version of the fused selective scan
(``selective_scan_kernel``): a PyTorch port of the JAX package's
``repro.models.ssm._fused_chunk_scan``, chunk by chunk, with the
recurrence run in order inside each chunk.
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


def check_selective_args(xh: torch.Tensor, dt: torch.Tensor,
                         A: torch.Tensor, bc: torch.Tensor):
    """The selective scan's shapes and types: xh (B, S, di) and bc (B, S,
    2N) of one dtype, dt (B, S, di) and A (di, N) float32 -> (B, S, di,
    N).  Raises ValueError on anything else."""
    if xh.dim() != 3 or dt.shape != xh.shape or A.dim() != 2 \
            or A.shape[0] != xh.shape[2] or bc.dim() != 3 \
            or bc.shape[:2] != xh.shape[:2] or bc.shape[2] != 2 * A.shape[1]:
        raise ValueError(
            "the selective scan takes xh and dt of shape (B, S, di), A "
            "(di, N) and bc (B, S, 2N); got xh "
            f"{tuple(xh.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"bc {tuple(bc.shape)}")
    if bc.dtype != xh.dtype or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise ValueError(
            "the selective scan takes xh and bc of one dtype and dt and A "
            f"in float32; got xh {xh.dtype}, bc {bc.dtype}, dt {dt.dtype}, "
            f"A {A.dtype}")
    B, S, di = xh.shape
    return B, S, di, A.shape[1]


def fused_chunk(S: int) -> int:
    """JAX's ``_fused_chunk_scan`` chunk: ``min(256, S)``, halved until
    it divides S (32 at S = 2016)."""
    c = min(256, S)
    while S % c:
        c //= 2
    return c


def selective_scan_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       bc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fused_chunk_scan`` from a zero state: per chunk of
    :func:`fused_chunk` steps, the coefficients ``dA = exp(dt A)`` and
    ``dBx = (dt B) x`` (B, c, di, N) formed as ``_ssm_coeffs`` forms
    them, the recurrence ``h = dA h + dBx`` in order, carried from chunk
    to chunk, and ``y = einsum(h, C)`` summed over n in order (the
    kernel's order: the two agree bit for bit).  xh (B, S, di), dt (B, S, di)
    fp32, A (di, N) fp32, bc (B, S, 2N) in xh's dtype -> (y (B, S, di),
    h_last (B, di, N)), both fp32."""
    B, S, di, N = check_selective_args(xh, dt, A, bc)
    c = fused_chunk(S) if S else 1
    h = torch.zeros((B, di, N), dtype=torch.float32, device=xh.device)
    y = torch.empty((B, S, di), dtype=torch.float32, device=xh.device)
    for s0 in range(0, S, c):
        dt_c = dt[:, s0:s0 + c]
        bc_c = bc[:, s0:s0 + c]
        dA = (dt_c[..., None] * A).exp_()
        dBx = dt_c[..., None] * bc_c[..., None, :N].to(torch.float32)
        dBx.mul_(xh[:, s0:s0 + c, :, None].to(torch.float32))
        hs = torch.empty_like(dBx)
        for t in range(c):
            h = dA[:, t] * h + dBx[:, t]
            hs[:, t] = h
        # JAX's einsum with C, summed over n in order: h_0 C_0, then
        # + h_n C_n, each product and sum rounded alone
        Cc = bc_c[..., N:].to(torch.float32)
        yc = hs[..., 0] * Cc[..., 0, None]
        for n in range(1, N):
            yc = yc + hs[..., n] * Cc[..., n, None]
        y[:, s0:s0 + c] = yc
    return y, h
