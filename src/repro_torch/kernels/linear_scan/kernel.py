"""Wrapper for the hand-written CUDA linear-recurrence kernel.

The kernel (``csrc/linear_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.linear_scan.kernel.linear_scan_kernel``.  It is built
with ``nvcc`` at first use (``repro_torch.kernels.build``) and called
through ``ctypes`` on PyTorch's current stream.

The kernel computes the forward recurrence only: the wrapper refuses
inputs that require grad under grad mode rather than return states with
no autograd history, so the SSM and hybrid models do not train on the
card until the scan has a backward.

``linear_scan_kernel.launches`` counts the launches this process made; a
run that resets it to 0 and reads it afterwards can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    lib = build.load("linear_scan")
    fn = lib.linear_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def linear_scan_kernel(a: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (B, S, C) or (B, S, 1) (broadcast over C), b: (B, S, C), both
    contiguous CUDA tensors of one dtype (fp32 or bf16) -> (h (B, S, C),
    h_last (B, C)) in that dtype, from a zero carry.  Raises on anything
    else, and where grad mode is on and a or b requires grad."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(
            "linear_scan_kernel has no backward, and its states would train "
            "with missing gradients: a backward scan is later work, so the "
            "SSM and hybrid models (Mamba, RG-LRU) train on the CPU only")
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
    fn = _entry()
    args = (a.data_ptr(), b.data_ptr(), h.data_ptr(), h_last.data_ptr(),
            B, S, C, int(a.shape[2] != 1), _DTYPES[b.dtype])
    if b.get_device() == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the runtime launches on its current device: switch to b's
        with torch.cuda.device(b.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"linear_scan kernel launch failed: CUDA error {err} at shape "
            f"{tuple(b.shape)} {b.dtype}")
    linear_scan_kernel.launches += 1
    return h, h_last


linear_scan_kernel.launches = 0
