"""Plain PyTorch version of flash attention: dense masked softmax.

Layout as ``repro.kernels.flash_attention.ref``: q ``(B, H, Sq, hd)``,
k/v ``(B, KV, Skv, hd)`` with GQA group ``G = H // KV`` (head ``h``
reads KV head ``h // G``); causal and sliding-window masks from absolute
int positions; masked scores are ``-1e30``.  Computed in fp32, cast to
q's dtype.  The CPU path of the model runs it; on the card it is the
yardstick the CUDA kernel is held against.  A row whose keys are all
masked gets uniform weights, the mean of v over every key.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, k_positions: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    # (B, KV, G, Sq, hd) against (B, KV, Skv, hd): GQA without repeating K/V
    qg = q.reshape(B, KV, G, Sq, hd).to(torch.float32)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(torch.float32)) * scale
    qp = q_positions.to(torch.int64)[:, None, None, :, None]
    kp = k_positions.to(torch.int64)[:, None, None, None, :]
    mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, hd).to(q.dtype)
