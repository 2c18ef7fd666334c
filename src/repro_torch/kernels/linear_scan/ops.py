"""Dispatcher for the linear recurrence, and the engine's fold prefix.

A CUDA tensor always goes to the hand-written kernel (``kernel.py``); a
CPU tensor goes to the plain PyTorch version (``ref.py``).  There is no
size threshold and no fallback: a kernel that fails to build or launch
raises.  ``use_kernel`` (``RunConfig.fold_kernel`` for the fold) may only
confirm what the device decides — ``None`` lets the device decide,
``True`` on a CPU tensor or ``False`` on a CUDA tensor raises.

Under grad, :func:`linear_scan` goes through :class:`LinearScan`, whose
backward is the reverse recurrence: the backward kernel on a CUDA
tensor, the plain reverse loop on a CPU tensor.  Everything else
(serving, the fold) takes the forward alone, launch for launch as
before.

:func:`selective_scan` is the Mamba layer's fused scan (the JAX
package's default ``_fused_chunk_scan``): the fused kernel on a CUDA
tensor, its plain version on a CPU tensor.  Under grad it goes through
:class:`SelectiveScan`, which saves the state before each chunk and
whose backward recomputes one chunk at a time from it, as JAX's
checkpointed chunk body: the fused backward kernel on a CUDA tensor, its
plain version on a CPU tensor.

:func:`fold_prefix` maps one tick's affine server-fold stream onto the
recurrence: B=1, S = the tick's bucket, C = one carrier leaf's size, the
(S,) coefficients broadcast over C — one launch per carrier leaf.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.common.pytree import Tree, tree_flatten, tree_unflatten
from repro_torch.kernels.linear_scan.kernel import (
    linear_scan_backward_kernel, linear_scan_kernel,
    selective_scan_backward_kernel, selective_scan_kernel)
from repro_torch.kernels.linear_scan.ref import (
    check_selective_args, linear_scan_backward_ref, linear_scan_ref,
    selective_scan_backward_ref, selective_scan_ref)


def _on_card(x: torch.Tensor, use_kernel: Optional[bool],
             flag: str = "fold_kernel") -> bool:
    on_card = x.is_cuda
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(
            f"{flag}={use_kernel!r} contradicts the tensor's device "
            f"({x.device}): the CUDA kernel runs exactly on CUDA tensors, "
            "the plain version exactly on CPU tensors (use None)")
    return on_card


def _scan(a: torch.Tensor, b: torch.Tensor, on_card: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    if on_card:
        return linear_scan_kernel(a.contiguous(), b.contiguous())
    return linear_scan_ref(a, b)


class LinearScan(torch.autograd.Function):
    """The recurrence on (B, S, C) ``a`` and ``b`` under autograd: the
    forward as :func:`_scan` dispatches it, saving ``(a, h)``; the
    backward the reverse recurrence, the backward kernel on a CUDA
    tensor and its plain version on a CPU tensor.  A gradient of ``h``
    or ``h_last`` that autograd passes as None is taken as zero."""

    @staticmethod
    def forward(ctx, a, b, on_card: bool):
        h, h_last = _scan(a, b, on_card)
        ctx.save_for_backward(a, h)
        ctx.set_materialize_grads(False)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        if a.is_cuda:
            da, db = linear_scan_backward_kernel(
                a, h, dh.contiguous(),
                None if dh_last is None else dh_last.contiguous())
        else:
            da, db = linear_scan_backward_ref(a, h, dh, dh_last)
        return da, db, None


def _check_grad(a: torch.Tensor, b: torch.Tensor) -> None:
    """The shapes and types :class:`LinearScan` differentiates."""
    if a.shape != b.shape:
        raise ValueError(
            "LinearScan differentiates a full (B, S, C) a only; got a "
            f"{tuple(a.shape)} broadcast over b {tuple(b.shape)} (the "
            "fold's layout, which is never differentiated)")
    # float32, the backward kernel's type; on the CPU float64 as well,
    # for gradient checks
    types = (torch.float32,) if b.is_cuda else (torch.float32, torch.float64)
    if a.dtype != b.dtype or b.dtype not in types:
        raise TypeError(
            f"LinearScan on {b.device.type} differentiates a and b of one "
            f"type of {[str(t) for t in types]}; got {a.dtype} and "
            f"{b.dtype} (no bfloat16 backward)")


def linear_scan(a: torch.Tensor, b: torch.Tensor, *,
                use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + b_t`` along axis 1 from a zero carry.

    ``a`` and ``b`` share a ``(B, S, ...)`` layout (Mamba's ``(B, S,
    d_inner, N)``, RG-LRU's ``(B, S, width)``), flattened to ``C``
    channels.  Returns ``(h, h_last)`` in that layout and ``b.dtype``.
    With grad mode on and ``a`` or ``b`` requiring grad it goes through
    :class:`LinearScan` (a full ``a``, fp32; fp64 too on the CPU);
    otherwise the forward alone.
    """
    shape = b.shape
    B, S = shape[0], shape[1]
    a3, b3 = a.reshape(B, S, -1), b.reshape(B, S, -1)
    on_card = _on_card(b, use_kernel)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        _check_grad(a3, b3)
        if on_card:  # the kernels take contiguous tensors (no copy if so)
            a3, b3 = a3.contiguous(), b3.contiguous()
        h, h_last = LinearScan.apply(a3, b3, on_card)
    else:
        h, h_last = _scan(a3, b3, on_card)
    return h.reshape(shape), h_last.reshape((B,) + tuple(shape[2:]))


def _selective(xh, dt, A, bc, on_card: bool, chunks: bool = False):
    if on_card:
        return selective_scan_kernel(xh.contiguous(), dt.contiguous(),
                                     A.contiguous(), bc.contiguous(),
                                     chunks=chunks)
    return selective_scan_ref(xh, dt, A, bc, chunks=chunks)


class SelectiveScan(torch.autograd.Function):
    """The fused selective scan under autograd.  The forward is one
    :func:`_selective` call that also returns the state before each
    chunk, ``h_chunks`` (B, S / c, di, N); it saves ``(xh, dt, A, bc,
    h_chunks)`` and no (B, S, di, N) tensor.  The backward recomputes a
    chunk's states at a time from those carries (JAX's checkpointed chunk
    body): the fused backward kernel on a CUDA tensor, its plain version
    on a CPU tensor.  A gradient of y or h_last that autograd passes as
    None is taken as zero."""

    @staticmethod
    def forward(ctx, xh, dt, A, bc, on_card: bool):
        y, h_last, h_chunks = _selective(xh, dt, A, bc, on_card, chunks=True)
        ctx.save_for_backward(xh, dt, A, bc, h_chunks)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, gh_last):
        xh, dt, A, bc, h_chunks = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(dt)
        if xh.is_cuda:
            grads = selective_scan_backward_kernel(
                xh, dt, A, bc, h_chunks, gy.contiguous(),
                None if gh_last is None else gh_last.contiguous())
        else:
            grads = selective_scan_backward_ref(xh, dt, A, bc, h_chunks, gy,
                                                gh_last)
        return (*grads, None)


def _check_selective_grad(xh: torch.Tensor) -> None:
    """The types :class:`SelectiveScan` differentiates."""
    # float32, the backward kernel's type; on the CPU float64 as well,
    # for gradient checks
    types = (torch.float32,) if xh.is_cuda else (torch.float32,
                                                 torch.float64)
    if xh.dtype not in types:
        raise TypeError(
            f"SelectiveScan on {xh.device.type} differentiates xh and bc "
            f"of one type of {[str(t) for t in types]}; got {xh.dtype} (no "
            "bfloat16 backward)")


def selective_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   bc: torch.Tensor, *, use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Mamba layer's selective scan from a zero state: ``xh`` (B, S, di)
    and ``bc`` (B, S, 2N) in the model's dtype, ``dt`` (B, S, di) after
    the softplus and ``A = -exp(A_log)`` (di, N) in fp32 -> (``y = h . C``
    (B, S, di), ``h_last`` (B, di, N)), both fp32.  With grad mode on and
    an input requiring grad it goes through :class:`SelectiveScan` (fp32;
    fp64 too on the CPU); otherwise the forward alone."""
    on_card = _on_card(xh, use_kernel, "use_kernel")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, A, bc)):
        check_selective_args(xh, dt, A, bc)
        _check_selective_grad(xh)
        if on_card:  # the kernels take contiguous tensors (no copy if so)
            xh, dt, A, bc = (t.contiguous() for t in (xh, dt, A, bc))
        return SelectiveScan.apply(xh, dt, A, bc, on_card)
    return _selective(xh, dt, A, bc, on_card)


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
