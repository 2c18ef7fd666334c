"""Wrappers for the hand-written CUDA feature-pass kernels (Eq. 5-6).

Both kernels live in ``csrc/feature_attention.cu`` and replace the Pallas
TPU kernel ``repro.kernels.feature_attention.kernel.
feature_attention_kernel``: :func:`feature_attention_kernel` is the
per-row pass alone, :func:`feature_fold_kernel` ASO-Fed's whole
sequential server fold of a tick (the Eq. 4 axpy on every leaf and the
pass on the first layer after each arrival), which is how the engine's
main path reaches the pass; :func:`feature_attention_plan` reports how
the per-row pass lays out a given matrix.  They are built with ``nvcc``
at first use (``repro_torch.kernels.build``) and called through
``ctypes`` on PyTorch's current stream.

Each wrapper's ``launches`` counts the launches this process made; a run
that resets it to 0 and reads it afterwards can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

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

# feature_attention_plan's fields, in the C entry's order
_PLAN_FIELDS = ("route", "vector_elems", "vectors_per_lane", "warps_per_row",
                "unmasked", "threads_per_block", "grid", "blocks_per_sm",
                "registers", "local_bytes", "sms")
_ROUTES = ("vector", "scalar", "wide")


def feature_attention_plan(w: torch.Tensor) -> dict:
    """How :func:`feature_attention_kernel` lays out and launches ``w``
    (a contiguous 2-D fp32 or bf16 CUDA tensor), for the record: its
    route (``vector``: 16-byte accesses; ``scalar``: masked element
    accesses; ``wide``: a block a row), the vector width, vectors a lane,
    warps a row, whether the masks compile away, threads a block, grid,
    resident blocks an SM, the instance's registers and local (spill)
    bytes a thread, and the SMs.  Launches nothing and counts nothing."""
    if not w.is_cuda or w.dtype not in _DTYPES or w.dim() != 2:
        raise ValueError("feature_attention_plan takes a 2-D float32 or "
                         "bfloat16 CUDA tensor")
    lib = build.load("feature_attention")
    fn = lib.feature_attention_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(_PLAN_FIELDS))()
    # the output is allocated 16-byte aligned, as the wrapper's empty_like
    with torch.cuda.device(w.device):
        err = fn(w.data_ptr(), 0, w.shape[0], w.shape[1], _DTYPES[w.dtype],
                 info)
    if err != 0:
        raise RuntimeError(f"feature_attention_plan failed: CUDA error {err}")
    plan = dict(zip(_PLAN_FIELDS, info))
    plan["route"] = _ROUTES[plan["route"]]
    plan["unmasked"] = bool(plan["unmasked"])
    return plan


# the kernel's by-value parameter block holds this many leaves
FOLD_MAX_LEAVES = 16
# shared memory a block may use on the card (227 KB)
_SMEM_LIMIT = 232448


def _fold_entry():
    lib = build.load("feature_attention")
    fn = lib.feature_fold_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, i, i, i, p, p, i, p, p, p, i, i, i,
                       p]
        fn.restype = ctypes.c_int
    return fn


def feature_fold_kernel(w: Sequence[torch.Tensor],
                        deltas: Sequence[torch.Tensor], first: int,
                        rows: int, cols: int, n: torch.Tensor,
                        idx: torch.Tensor, n_vis: torch.Tensor, n_real: int,
                        normalize: bool = True,
                        reps: Optional[torch.Tensor] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                   List[torch.Tensor]]:
    """ASO-Fed's sequential server fold of one tick, in one launch.

    w: the server's leaves; deltas: the uploads, ``(S, *leaf.shape)`` per
    leaf; ``w[first]`` is the first layer, ``rows * cols`` elements whose
    rows take the feature pass; n: the ``(n_len,)`` counts; idx (int64)
    and n_vis: ``(S,)``; the first ``n_real`` slots are real; reps: None
    (every real slot folds once) or the ``(S,)`` int32 fold count of each
    slot (0, 1 or 2), read by the kernel from device memory.  All
    contiguous CUDA tensors on one device, fp32 but idx and reps.
    Returns (the post-tick leaves, the post-tick counts, the received
    models stacked ``(S, *leaf.shape)``, slots past ``n_real`` a copy of
    the last real one; a slot that does not fold receives the model as
    it stands).  Raises on anything else."""
    L = len(w)
    if not 1 <= L <= FOLD_MAX_LEAVES or len(deltas) != L \
            or not 0 <= first < L:
        raise ValueError(
            f"feature_fold_kernel takes 1 to {FOLD_MAX_LEAVES} leaves with "
            f"one upload each and the first layer among them; got {L} "
            f"leaves, {len(deltas)} uploads, first={first}")
    floats = [*w, *deltas, n, n_vis]
    ints = [idx] + ([] if reps is None else [reps])
    if not all(t.is_cuda for t in floats + ints):
        raise ValueError("feature_fold_kernel needs CUDA tensors, got "
                         f"{sorted({str(t.device) for t in floats + ints})}")
    dev = n.device
    if any(t.device != dev for t in floats + ints):
        raise ValueError("feature_fold_kernel takes tensors on one device")
    if any(t.dtype != torch.float32 for t in floats) \
            or idx.dtype != torch.int64 \
            or (reps is not None and reps.dtype != torch.int32):
        raise ValueError(
            "feature_fold_kernel takes float32 leaves, uploads, n and "
            "n_vis, an int64 idx and an int32 reps (the engine's state is "
            f"fp32); got {sorted({str(t.dtype) for t in floats + ints})}")
    if not all(t.is_contiguous() for t in floats + ints):
        raise ValueError("feature_fold_kernel takes contiguous tensors")
    S = deltas[0].shape[0] if deltas[0].dim() else 0
    if reps is not None and reps.shape != (S,):
        raise ValueError(f"feature_fold_kernel takes reps of shape ({S},), "
                         f"got {tuple(reps.shape)}")
    if n.dim() != 1 or idx.shape != (S,) or n_vis.shape != (S,) \
            or any(tuple(d.shape) != (S,) + tuple(x.shape)
                   for x, d in zip(w, deltas)):
        raise ValueError(
            "feature_fold_kernel takes uploads of shape (S, *leaf), idx and "
            f"n_vis of shape (S,) and a 1-D n; got S={S}, idx "
            f"{tuple(idx.shape)}, n_vis {tuple(n_vis.shape)}, n "
            f"{tuple(n.shape)}")
    if not 1 <= n_real <= S or rows < 1 or cols < 1 \
            or w[first].numel() != rows * cols:
        raise ValueError(
            f"feature_fold_kernel: n_real={n_real} outside 1..{S}, or "
            f"(rows, cols)=({rows}, {cols}) not the first layer's "
            f"{w[first].numel()} elements")
    if max(x.numel() for x in w) >= 2 ** 31 or n.numel() >= 2 ** 31:
        raise ValueError("a leaf or n exceeds the kernel's 32-bit "
                         "element counts")
    smem = 4 * (4 * S + (0 if cols <= 1024 else -(-cols // 32) * 32))
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"feature_fold_kernel: S={S} and cols={cols} need {smem} bytes "
            f"of shared memory a block, above the card's {_SMEM_LIMIT}")
    w_out = [torch.empty_like(x) for x in w]
    rec = [torch.empty_like(d) for d in deltas]
    n_out = torch.empty_like(n)

    def ptrs(ts):
        return (ctypes.c_void_p * L)(*[t.data_ptr() for t in ts])

    fn = _fold_entry()
    args = (L, ptrs(w), ptrs(deltas), ptrs(w_out), ptrs(rec),
            (ctypes.c_int * L)(*[x.numel() for x in w]), first, rows, cols,
            n.data_ptr(), n_out.data_ptr(), n.numel(), idx.data_ptr(),
            n_vis.data_ptr(), None if reps is None else reps.data_ptr(), S,
            n_real, int(bool(normalize)))
    if n.get_device() == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the runtime launches on its current device: switch to n's
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"feature_fold kernel launch failed: CUDA error {err} at S={S}, "
            f"n_real={n_real}, first layer ({rows}, {cols}), {L} leaves")
    feature_fold_kernel.launches += 1
    return w_out, n_out, rec


feature_fold_kernel.launches = 0
