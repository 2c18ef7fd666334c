"""Wrappers for the hand-written CUDA linear-recurrence kernels.

The kernel (``csrc/linear_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.linear_scan.kernel.linear_scan_kernel``.  It is built
with ``nvcc`` at first use (``repro_torch.kernels.build``) and called
through ``ctypes`` on PyTorch's current stream.

``selective_scan_kernel`` (``csrc/selective_scan.cu``) is the recurrence
redesigned for the Mamba layer: the port of the JAX package's default
``_fused_chunk_scan``, which forms ``exp(dt A)`` and ``dt B x`` in
registers, runs the recurrence and writes ``y = h . C`` and the last
state, so no ``(B, S, d_inner, N)`` tensor exists; under grad it also
writes the state before each chunk, from which
``selective_scan_backward_kernel`` recomputes a chunk's states on the SM,
a stage of steps at a time, and walks them in reverse (the gradients of
xh, dt, A and bc).

``linear_scan_kernel`` launches the forward recurrence and
``linear_scan_backward_kernel`` its reverse (fp32, the gradients of a
and b).  The forward wrapper refuses inputs that require grad under grad
mode rather than return states with no autograd history: the
differentiable route is ``ops.linear_scan``, whose autograd Function
launches both, and through which RG-LRU trains on the card; the Mamba
layer trains through ``ops.selective_scan``'s autograd Function, which
launches the fused scan and its backward.

Each wrapper's ``launches`` counts the launches this process made; a
run that resets it to 0 and reads it afterwards can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.linear_scan.ref import (check_selective_args,
                                                 fused_chunk)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# C entry -> (library, pointer arguments, int arguments), then the stream
_ENTRIES = {"linear_scan_launch": ("linear_scan", 4, 5),
            "linear_scan_backward_launch": ("linear_scan", 6, 3),
            "selective_scan_launch": ("selective_scan", 7, 6),
            "selective_scan_backward_launch": ("selective_scan", 11, 5)}


def _entry(name: str = "linear_scan_launch"):
    lib, ptrs, ints = _ENTRIES[name]
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, args, ref: torch.Tensor) -> int:
    """``fn(*args, stream)`` on ``ref``'s device and current stream."""
    if ref.get_device() == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    # the runtime launches on its current device: switch to ref's
    with torch.cuda.device(ref.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def linear_scan_kernel(a: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (B, S, C) or (B, S, 1) (broadcast over C), b: (B, S, C), both
    contiguous CUDA tensors of one dtype (fp32 or bf16) -> (h (B, S, C),
    h_last (B, C)) in that dtype, from a zero carry.  Raises on anything
    else, and where grad mode is on and a or b requires grad."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(
            "linear_scan_kernel returns states with no autograd history: "
            "call repro_torch.kernels.linear_scan.ops.linear_scan, the "
            "differentiable route, which launches this kernel and "
            "linear_scan_backward_kernel")
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(
            f"linear_scan_kernel needs CUDA tensors, got {a.device} and "
            f"{b.device}")
    if b.dtype not in _DTYPES or a.dtype != b.dtype:
        raise ValueError(
            "linear_scan_kernel takes a and b of one dtype, float32 or "
            f"bfloat16; got {a.dtype} and {b.dtype}")
    if b.dim() != 3 or a.dim() != 3 or a.shape[:2] != b.shape[:2] \
            or a.shape[2] not in (1, b.shape[2]):
        raise ValueError(
            "linear_scan_kernel takes b of shape (B, S, C) and a of shape "
            f"(B, S, C) or (B, S, 1); got a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("linear_scan_kernel takes contiguous tensors")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    B, S, C = b.shape
    if B > 65535 or b.numel() >= 2 ** 62 or max(S, C) >= 2 ** 31:
        raise ValueError(f"shape {tuple(b.shape)} exceeds the kernel's "
                         "grid or 32-bit sequence/channel indices")
    h = torch.empty_like(b)
    h_last = torch.empty((B, C), dtype=b.dtype, device=b.device)
    err = _launch(_entry(), (a.data_ptr(), b.data_ptr(), h.data_ptr(),
                             h_last.data_ptr(), B, S, C,
                             int(a.shape[2] != 1), _DTYPES[b.dtype]), b)
    if err != 0:
        raise RuntimeError(
            f"linear_scan kernel launch failed: CUDA error {err} at shape "
            f"{tuple(b.shape)} {b.dtype}")
    linear_scan_kernel.launches += 1
    return h, h_last


linear_scan_kernel.launches = 0


def linear_scan_backward_kernel(a: torch.Tensor, h: torch.Tensor,
                                dh: torch.Tensor,
                                dh_last: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse of the recurrence: a, the forward's h and the gradient
    dh of h, all (B, S, C), and the gradient dh_last (B, C) of h_last
    (None: zero), contiguous fp32 CUDA tensors -> (da, db), both (B, S,
    C) fp32.  Raises on anything else: bf16, a broadcast (B, S, 1) a,
    CPU tensors."""
    ts = (a, h, dh) + (() if dh_last is None else (dh_last,))
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(
            "linear_scan_backward_kernel takes float32 only; got "
            f"{[str(t.dtype) for t in ts]}")
    if h.dim() != 3 or a.shape != h.shape or dh.shape != h.shape or (
            dh_last is not None and dh_last.shape != (h.shape[0],
                                                      h.shape[2])):
        raise ValueError(
            "linear_scan_backward_kernel takes a full (B, S, C) a (not a "
            "broadcast (B, S, 1) one), h and dh of that shape and dh_last "
            f"(B, C); got a {tuple(a.shape)}, h {tuple(h.shape)}, dh "
            f"{tuple(dh.shape)}, dh_last "
            f"{None if dh_last is None else tuple(dh_last.shape)}")
    if not all(t.is_cuda for t in ts):
        raise ValueError(
            "linear_scan_backward_kernel needs CUDA tensors, got "
            f"{[str(t.device) for t in ts]}")
    if any(t.device != h.device for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("linear_scan_backward_kernel takes contiguous "
                         "tensors")
    B, S, C = h.shape
    if B > 65535 or h.numel() >= 2 ** 62 or max(S, C) >= 2 ** 31:
        raise ValueError(f"shape {tuple(h.shape)} exceeds the kernel's "
                         "grid or 32-bit sequence/channel indices")
    da = torch.empty_like(h)
    db = torch.empty_like(h)
    err = _launch(_entry("linear_scan_backward_launch"), (
        a.data_ptr(), h.data_ptr(), dh.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
        db.data_ptr(), B, S, C), h)
    if err != 0:
        raise RuntimeError(
            f"linear_scan backward kernel launch failed: CUDA error {err} "
            f"at shape {tuple(h.shape)}")
    linear_scan_backward_kernel.launches += 1
    return da, db


linear_scan_backward_kernel.launches = 0


# the selective scan's state size: the kernel keeps N states a thread in
# registers, compiled for Mamba-1's 16
SELECTIVE_N = 16


def _selective_checks(name: str, ts, xh, dt, A, bc, types):
    """The fused kernels' common refusals; returns (B, S, di, N)."""
    if not all(t.is_cuda for t in ts):
        raise ValueError(
            f"{name} needs CUDA tensors, got {[str(t.device) for t in ts]}")
    if any(t.device != xh.device for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}")
    B, S, di, N = check_selective_args(xh, dt, A, bc)
    if xh.dtype not in types:
        raise ValueError(f"{name} takes xh and bc in "
                         f"{' or '.join(str(t) for t in types)}; got "
                         f"{xh.dtype}")
    if N != SELECTIVE_N or di % 8:
        raise ValueError(
            f"{name} is compiled for N = {SELECTIVE_N} and d_inner a "
            f"multiple of 8; got N = {N}, d_inner = {di}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} takes 16-byte aligned tensors (its "
                         "copies move 16 bytes)")
    if B > 65535 or xh.numel() * N >= 2 ** 62:
        raise ValueError(f"shape {tuple(xh.shape)} exceeds the kernel's grid")
    return B, S, di, N


def selective_scan_kernel(xh: torch.Tensor, dt: torch.Tensor,
                          A: torch.Tensor, bc: torch.Tensor,
                          chunks: bool = False):
    """The fused selective scan from a zero state: ``xh`` (B, S, di) and
    ``bc`` (B, S, 2N) of one dtype (fp32 or bf16; B is bc's first N
    columns, C its last N), ``dt`` (B, S, di) and ``A`` (di, N) fp32, all
    contiguous CUDA tensors on one device, N = 16, di a multiple of 8 ->
    (y (B, S, di), h_last (B, di, N)), both fp32; with ``chunks`` also
    ``h_chunks`` (B, S / c, di, N) fp32, the state before each chunk of c
    = ``fused_chunk(S)`` steps (the backward's carries).  Raises on
    anything else, and where grad mode is on and an input requires
    grad."""
    ts = (xh, dt, A, bc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "selective_scan_kernel returns outputs with no autograd "
            "history: call repro_torch.kernels.linear_scan.ops."
            "selective_scan, the differentiable route, which launches this "
            "kernel and selective_scan_backward_kernel")
    B, S, di, N = _selective_checks("selective_scan_kernel", ts, *ts,
                                    tuple(_DTYPES))
    y = torch.empty((B, S, di), dtype=torch.float32, device=xh.device)
    h_last = (torch.empty if S else torch.zeros)(
        (B, di, N), dtype=torch.float32, device=xh.device)
    c = fused_chunk(S) if S else 1
    h_chunks = (torch.empty((B, S // c, di, N), dtype=torch.float32,
                            device=xh.device) if chunks else None)
    err = _launch(_entry("selective_scan_launch"), (
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), bc.data_ptr(),
        y.data_ptr(), h_last.data_ptr(),
        None if h_chunks is None else h_chunks.data_ptr(), B, S, di, N, c,
        _DTYPES[xh.dtype]), xh)
    if err != 0:
        raise RuntimeError(
            f"selective_scan kernel launch failed: CUDA error {err} at shape "
            f"{(B, S, di, N)} {xh.dtype}")
    selective_scan_kernel.launches += 1
    return (y, h_last, h_chunks) if chunks else (y, h_last)


selective_scan_kernel.launches = 0

# the fused backward's channels a block: its partial sums of dB and dC
# come one a block of this many d_inner channels
SELECTIVE_BLOCK = 32


def selective_scan_backward_kernel(xh: torch.Tensor, dt: torch.Tensor,
                                   A: torch.Tensor, bc: torch.Tensor,
                                   h_chunks: torch.Tensor, gy: torch.Tensor,
                                   gh_last: Optional[torch.Tensor] = None):
    """The fused selective scan's backward: its inputs ``xh``, ``dt``
    (B, S, di), ``A`` (di, N) and ``bc`` (B, S, 2N), the forward's
    ``h_chunks`` (B, S / c, di, N), the gradient ``gy`` (B, S, di) of y
    and ``gh_last`` (B, di, N) of h_last (None: zero), all contiguous fp32
    CUDA tensors on one device -> (dxh, ddt (B, S, di), dA (di, N), dbc
    (B, S, 2N)), fp32.  One launch; dA and dbc are its per-block partials
    summed in a fixed order.  Raises on anything else: bf16, N != 16, a
    CPU tensor."""
    ts = (xh, dt, A, bc, h_chunks, gy) + (
        () if gh_last is None else (gh_last,))
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(
            "selective_scan_backward_kernel takes float32 only; got "
            f"{[str(t.dtype) for t in ts]}")
    B, S, di, N = _selective_checks("selective_scan_backward_kernel", ts,
                                    xh, dt, A, bc, (torch.float32,))
    c = fused_chunk(S) if S else 1
    if tuple(h_chunks.shape) != (B, S // c, di, N) \
            or tuple(gy.shape) != (B, S, di) or (
                gh_last is not None and tuple(gh_last.shape) != (B, di, N)):
        raise ValueError(
            "selective_scan_backward_kernel takes h_chunks (B, S / c, di, "
            f"N) = {(B, S // c, di, N)}, gy (B, S, di) and gh_last (B, di, "
            f"N); got h_chunks {tuple(h_chunks.shape)}, gy "
            f"{tuple(gy.shape)}, gh_last "
            f"{None if gh_last is None else tuple(gh_last.shape)}")
    dev = xh.device
    if not S:
        return (torch.zeros_like(dt), torch.zeros_like(dt),
                torch.zeros_like(A),
                torch.zeros((B, 0, 2 * N), dtype=torch.float32, device=dev))
    dxh = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    ddt = torch.empty_like(dxh)
    n_blocks = -(-di // SELECTIVE_BLOCK)
    dA_part = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    dbc_part = torch.empty((n_blocks, B, S, 2 * N), dtype=torch.float32,
                           device=dev)
    err = _launch(_entry("selective_scan_backward_launch"), (
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), bc.data_ptr(),
        h_chunks.data_ptr(), gy.data_ptr(),
        None if gh_last is None else gh_last.data_ptr(), dxh.data_ptr(),
        ddt.data_ptr(), dA_part.data_ptr(), dbc_part.data_ptr(), B, S, di,
        N, c), xh)
    if err != 0:
        raise RuntimeError(
            "selective_scan backward kernel launch failed: CUDA error "
            f"{err} at shape {(B, S, di, N)}")
    selective_scan_backward_kernel.launches += 1
    return dxh, ddt, dA_part.sum(0), dbc_part.sum(0)


selective_scan_backward_kernel.launches = 0
