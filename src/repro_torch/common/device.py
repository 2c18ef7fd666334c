"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The run's device: ``None`` means the CUDA card, and without one
    this raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain-PyTorch path on the CPU")
    return dev
