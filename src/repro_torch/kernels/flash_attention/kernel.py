"""Wrapper for the hand-written CUDA flash-attention kernel (forward).

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_kernel``.  It is
built with ``nvcc`` at first use (``repro_torch.kernels.build``) and
called through ``ctypes`` on PyTorch's current stream.  It reads the
model's layout directly (q ``(B, Sq, KV, G, hd)``, k/v ``(B, Skv, KV,
hd)``), so no transposed copies are made around it.

The kernel computes the forward pass only: the wrapper refuses inputs
that require grad under grad mode rather than return an output with no
autograd history.  Training takes the plain attention
(``gqa_forward(..., attention="blocked")``, what ``Model.loss`` does).

``flash_attention_kernel.launches`` counts the launches this process
made; a run that resets it to 0 and reads it afterwards can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128, 256)


def _entry():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_positions, k_positions) -> None:
    """Types and shapes first (the head dim among them), then devices,
    contiguity and alignment."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            "flash_attention_kernel takes q, k, v of one dtype, float32 or "
            f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise ValueError("positions must be int32")
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            "flash_attention_kernel takes q (B, Sq, KV, G, hd) and k, v "
            f"(B, Skv, KV, hd); got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(q_positions.shape) != (B, Sq) \
            or tuple(k_positions.shape) != (B, Skv):
        raise ValueError(
            f"positions must be (B, Sq) = {(B, Sq)} and (B, Skv) = "
            f"{(B, Skv)}; got {tuple(q_positions.shape)} and "
            f"{tuple(k_positions.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention_kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if B > 65535 or (Sq + 63) // 64 > 65535 or q.numel() >= 2 ** 62 \
            or max(Sq, Skv, KV * G) >= 2 ** 31:
        raise ValueError(f"shape q {tuple(q.shape)}, k {tuple(k.shape)} "
                         "exceeds the kernel's grid or 32-bit indices")
    ts = {"q": q, "k": k, "v": v, "q_positions": q_positions,
          "k_positions": k_positions}
    for name, t in ts.items():
        if not t.is_cuda:
            raise ValueError(f"flash_attention_kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_kernel takes contiguous "
                             f"tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_positions: torch.Tensor,
                           k_positions: torch.Tensor, *, causal: bool,
                           window: int, contiguous: bool) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd), k/v: (B, Skv, KV, hd), positions (B, Sq) /
    (B, Skv) int32, all contiguous on one CUDA device, q/k/v fp32 or bf16
    -> attention output (B, Sq, KV, G, hd) in q's dtype, with scores
    scaled by 1 / sqrt(hd).  Raises on anything else, and where grad mode
    is on and q, k or v requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_kernel has no backward, and its output would "
            "train with missing gradients: training on the card takes the "
            "plain attention (gqa_forward(..., attention='blocked'), as "
            "Model.loss does)")
    _check(q, k, v, q_positions, k_positions)
    B, Sq, KV, G, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _entry()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            k_positions.data_ptr(), out.data_ptr(), B, KV * G, KV, Sq,
            k.shape[1], hd, 1.0 / math.sqrt(hd), int(bool(causal)),
            int(window), int(bool(contiguous)), _DTYPES[q.dtype])
    if q.get_device() == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the runtime launches on its current device: switch to q's
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} at q "
            f"{tuple(q.shape)}, k {tuple(k.shape)} {q.dtype}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
