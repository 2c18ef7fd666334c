"""One decode step of the linear recurrence h_t = a_t * h_{t-1} + b_t.

Mirrors ``repro.models.scan_utils.linear_scan_step``.  The whole-sequence
scan of a prefill goes through ``repro_torch.kernels.linear_scan.ops.
linear_scan`` (K2 on the card, its plain version on the CPU); the JAX
file's ``chunked_linear_scan`` has no caller in the port.
"""
from __future__ import annotations

import torch


def linear_scan_step(a_t: torch.Tensor, b_t: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    """Single decode step of the recurrence (fp32 internally), in
    ``h.dtype``."""
    h32 = h.to(torch.float32)
    out = a_t.to(torch.float32) * h32 + b_t.to(torch.float32)
    return out.to(h.dtype)
