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
recurrence run in order inside each chunk.  ``selective_scan_backward_ref``
is the plain version of its backward (``selective_scan_backward_kernel``):
what autograd derives through the JAX function's checkpointed chunk
body, one chunk at a time from its carried state, last chunk first.
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
    2N) of one dtype, dt (B, S, di) and A (di, N) float32 (float64 where
    xh is: gradient checks) -> (B, S, di, N).  Raises ValueError on
    anything else."""
    if xh.dim() != 3 or dt.shape != xh.shape or A.dim() != 2 \
            or A.shape[0] != xh.shape[2] or bc.dim() != 3 \
            or bc.shape[:2] != xh.shape[:2] or bc.shape[2] != 2 * A.shape[1]:
        raise ValueError(
            "the selective scan takes xh and dt of shape (B, S, di), A "
            "(di, N) and bc (B, S, 2N); got xh "
            f"{tuple(xh.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"bc {tuple(bc.shape)}")
    wide = _compute_dtype(xh)
    if bc.dtype != xh.dtype or dt.dtype != wide or A.dtype != wide:
        raise ValueError(
            "the selective scan takes xh and bc of one dtype and dt and A "
            "in float32 (float64 with float64 xh); got xh "
            f"{xh.dtype}, bc {bc.dtype}, dt {dt.dtype}, A {A.dtype}")
    B, S, di = xh.shape
    return B, S, di, A.shape[1]


def fused_chunk(S: int) -> int:
    """JAX's ``_fused_chunk_scan`` chunk: ``min(256, S)``, halved until
    it divides S (32 at S = 2016)."""
    c = min(256, S)
    while S % c:
        c //= 2
    return c


def _chunk_coeffs(xh, dt, A, bc, s0: int, c: int, N: int):
    """One chunk's ``dA = exp(dt A)`` and ``dBx = (dt B) x`` (B, c, di,
    N), formed as ``_ssm_coeffs`` forms them, in dt's type."""
    dt_c = dt[:, s0:s0 + c]
    dA = (dt_c[..., None] * A).exp_()
    dBx = dt_c[..., None] * bc[:, s0:s0 + c, None, :N].to(dt.dtype)
    dBx.mul_(xh[:, s0:s0 + c, :, None].to(dt.dtype))
    return dA, dBx


def _chunk_states(dA, dBx, h):
    """(B, c + 1, di, N): the carry ``h``, then the chunk's states in
    order."""
    hs = torch.empty((dA.shape[0], dA.shape[1] + 1) + dA.shape[2:],
                     dtype=dA.dtype, device=dA.device)
    hs[:, 0] = h
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs[:, t + 1] = h
    return hs


def _sum_over_n(v):
    """``v[..., 0] + v[..., 1] + ...`` in order, each sum rounded alone
    (the forward kernel's order)."""
    out = v[..., 0]
    for n in range(1, v.shape[-1]):
        out = out + v[..., n]
    return out


def _sum_over_n_lanes(v):
    """The sum over n in the backward kernel's order: n cut into four
    consecutive quarters (a channel's four threads), each summed in
    order, then ``(p0 + p2) + (p1 + p3)``; each sum rounded alone."""
    p = [_sum_over_n(q) for q in torch.tensor_split(v, 4, dim=-1)
         if q.shape[-1]]
    if len(p) < 4:  # N < 4: no kernel runs it; the quarters in order
        return _sum_over_n(torch.stack(p, -1))
    return (p[0] + p[2]) + (p[1] + p[3])


def selective_scan_ref(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       bc: torch.Tensor, chunks: bool = False):
    """``_fused_chunk_scan`` from a zero state: per chunk of
    :func:`fused_chunk` steps, the coefficients ``dA = exp(dt A)`` and
    ``dBx = (dt B) x`` (B, c, di, N) formed as ``_ssm_coeffs`` forms
    them, the recurrence ``h = dA h + dBx`` in order, carried from chunk
    to chunk, and ``y = einsum(h, C)`` summed over n in order (the
    kernel's order: the two agree bit for bit).  xh (B, S, di), dt (B, S, di)
    fp32, A (di, N) fp32, bc (B, S, 2N) in xh's dtype -> (y (B, S, di),
    h_last (B, di, N)), both fp32 (fp64 for fp64 inputs); with ``chunks``
    also ``h_chunks`` (B, S / c, di, N), the state before each chunk."""
    B, S, di, N = check_selective_args(xh, dt, A, bc)
    wide = dt.dtype
    c = fused_chunk(S) if S else 1
    h = torch.zeros((B, di, N), dtype=wide, device=xh.device)
    y = torch.empty((B, S, di), dtype=wide, device=xh.device)
    h_chunks = torch.empty((B, S // c, di, N), dtype=wide, device=xh.device)
    for k, s0 in enumerate(range(0, S, c)):
        h_chunks[:, k] = h
        hs = _chunk_states(*_chunk_coeffs(xh, dt, A, bc, s0, c, N), h)
        h = hs[:, -1]
        # JAX's einsum with C, summed over n in order: h_0 C_0, then
        # + h_n C_n, each product and sum rounded alone
        Cc = bc[:, s0:s0 + c, N:].to(wide)
        y[:, s0:s0 + c] = _sum_over_n(hs[:, 1:] * Cc[:, :, None, :])
    h = h.clone()
    return (y, h, h_chunks) if chunks else (y, h)


def selective_scan_backward_ref(xh: torch.Tensor, dt: torch.Tensor,
                                A: torch.Tensor, bc: torch.Tensor,
                                h_chunks: torch.Tensor, gy: torch.Tensor,
                                gh_last: Optional[torch.Tensor] = None):
    """The backward of :func:`selective_scan_ref`: its inputs, the
    forward's ``h_chunks`` and the gradients ``gy`` (B, S, di) of y and
    ``gh_last`` (B, di, N) of h_last (None: zero) -> (dxh, ddt (B, S,
    di), dA (di, N), dbc (B, S, 2N)), in dt's type.  Chunks last to
    first: the chunk's states recomputed from its carry in the forward's
    order (the same values bit for bit), then in reverse ``g_t = gy_t C_t
    + dA_{t+1} g_{t+1}`` (from ``gh_last``), and

    * ``dxh_t = sum_n g (dt B)``,
    * ``ddt_t = sum_n ((g h_{t-1}) dA) A + (g x) B``,
    * ``dA_n = sum_{b, t} ((g h_{t-1}) dA) dt``,
    * ``dB_t,n = sum_d (g x) dt``, ``dC_t,n = sum_d gy h_t``,

    each product rounded alone, the sums over n in the kernel's lane
    order (:func:`_sum_over_n_lanes`) and dA's over t in the walk's order
    (then over b), as the kernel rounds them: dxh, ddt and dA agree with
    it bit for bit (dbc is a sum over channels, taken in another order)."""
    B, S, di, N = check_selective_args(xh, dt, A, bc)
    wide = dt.dtype
    c = fused_chunk(S) if S else 1
    dxh = torch.empty((B, S, di), dtype=wide, device=xh.device)
    ddt = torch.empty_like(dxh)
    dbc = torch.empty((B, S, 2 * N), dtype=wide, device=xh.device)
    dA_b = torch.zeros((B, di, N), dtype=wide, device=xh.device)
    r = (torch.zeros((B, di, N), dtype=wide, device=xh.device)
         if gh_last is None else gh_last.to(wide))
    for k in range(S // c - 1, -1, -1):
        s0 = k * c
        dA, dBx = _chunk_coeffs(xh, dt, A, bc, s0, c, N)
        hs = _chunk_states(dA, dBx, h_chunks[:, k].to(wide))
        del dBx
        Bc = bc[:, s0:s0 + c, None, :N].to(wide)
        Cc = bc[:, s0:s0 + c, None, N:].to(wide)
        dt_c = dt[:, s0:s0 + c, :, None]
        gy_c = gy[:, s0:s0 + c, :, None].to(wide)
        g = gy_c * Cc  # gy C, then + dA_{t+1} g_{t+1} step by step
        for t in range(c - 1, -1, -1):
            g[:, t] += r
            r = dA[:, t] * g[:, t]
        dxh[:, s0:s0 + c] = _sum_over_n_lanes(g * (dt_c * Bc))
        gx = g * xh[:, s0:s0 + c, :, None].to(wide)
        q = (g * hs[:, :-1]) * dA
        del g, dA
        ddt[:, s0:s0 + c] = _sum_over_n_lanes(q * A + gx * Bc)
        dq = q * dt_c
        for t in range(c - 1, -1, -1):
            dA_b += dq[:, t]
        dbc[:, s0:s0 + c, :N] = (gx * dt_c).sum(2)
        dbc[:, s0:s0 + c, N:] = (gy_c * hs[:, 1:]).sum(2)
    return dxh, ddt, dA_b.sum(0), dbc
