"""What the drivers share: the device's clock and peak, the port's
precision settings, and freeing the program's state before the
reference runs."""
from __future__ import annotations

import gc

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    """Bytes the process's allocator held at most, from its start."""
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def fp32_highest() -> None:
    """fp32 products in fp32 (TF32 off), as the port's CLIs set them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
