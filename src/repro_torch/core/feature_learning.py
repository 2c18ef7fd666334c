"""Server-side global feature-representation learning (paper §4.1, Eq. 5-6).

After each aggregation the server reweights the *first layer after the
input* by a row-softmax attention over the weight magnitudes:

    alpha[i, j] = exp(|w1[i, j]|) / sum_j exp(|w1[i, j]|)
    w1[i, j]   <- alpha[i, j] * w1[i, j]

On the card this is the hand-written CUDA kernel
(``repro_torch.kernels.feature_attention``), one launch per call; the
engine's ASO-Fed fold reaches the pass through the fused tick fold
(``feature_attention.ops.feature_fold``) instead.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.feature_attention.ops import feature_attention


def first_layer_path(cfg: ModelConfig) -> str:
    """Key of the feature-learning target parameter."""
    if cfg.family == "lstm":
        return "w_x"
    if cfg.family == "cnn":
        return "conv1_w"
    raise ValueError(
        f"the port has no feature-learning layer for family {cfg.family!r}")


def apply_feature_learning(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                           *, use_kernel: Optional[bool] = None
                           ) -> Dict[str, torch.Tensor]:
    """Params with the Eq. (5)-(6) pass applied to the first layer (a new
    dict; the other leaves are shared).  ``use_kernel`` follows
    :func:`feature_attention`."""
    key = first_layer_path(cfg)
    out = dict(params)
    out[key] = feature_attention(params[key], use_kernel=use_kernel)
    return out
