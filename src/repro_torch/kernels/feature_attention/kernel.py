"""Wrapper for the hand-written CUDA feature-pass kernel (Eq. 5-6).

The kernel (``csrc/feature_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.feature_attention.kernel.feature_attention_kernel``.  It is
built with ``nvcc`` at first use (``repro_torch.kernels.build``) and
called through ``ctypes`` on PyTorch's current stream.

``feature_attention_kernel.launches`` counts the launches this process
made; a run that resets it to 0 and reads it afterwards can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    lib = build.load("feature_attention")
    fn = lib.feature_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def feature_attention_kernel(w: torch.Tensor, normalize: bool = True
                             ) -> torch.Tensor:
    """w: contiguous (rows, cols) fp32 or bf16 CUDA tensor -> reweighted
    copy of the same shape and dtype.  Raises on anything else."""
    if not w.is_cuda:
        raise ValueError(
            f"feature_attention_kernel needs a CUDA tensor, got {w.device}")
    if w.dtype not in _DTYPES:
        raise ValueError(
            f"feature_attention_kernel takes float32 or bfloat16, "
            f"got {w.dtype}")
    if w.dim() != 2 or not w.is_contiguous():
        raise ValueError(
            "feature_attention_kernel takes a contiguous 2-D (rows, cols) "
            f"tensor, got shape {tuple(w.shape)} "
            f"(contiguous={w.is_contiguous()})")
    rows, cols = w.shape
    if rows >= 2 ** 31 or cols >= 2 ** 31:
        raise ValueError(f"shape {tuple(w.shape)} exceeds the kernel's "
                         "32-bit row/column indices")
    out = torch.empty_like(w)
    fn = _entry()
    args = (w.data_ptr(), out.data_ptr(), rows, cols, _DTYPES[w.dtype],
            int(bool(normalize)))
    if w.get_device() == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the runtime launches on its current device: switch to w's
        with torch.cuda.device(w.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"feature_attention kernel launch failed: CUDA error {err} "
            f"at shape {tuple(w.shape)} {w.dtype}")
    feature_attention_kernel.launches += 1
    return out


feature_attention_kernel.launches = 0
