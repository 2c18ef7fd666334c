"""Server-side global feature-representation learning (paper §4.1, Eq. 5-6).

After each aggregation the server reweights the *first layer after the
input* by a row-softmax attention over the weight magnitudes:

    alpha[i, j] = exp(|w1[i, j]|) / sum_j exp(|w1[i, j]|)
    w1[i, j]   <- alpha[i, j] * w1[i, j]

The first layer is the paper models' first weight, or a transformer's
token embedding.  On the card this is the hand-written CUDA kernel
(``repro_torch.kernels.feature_attention``), one launch per call; the
engine's ASO-Fed fold reaches the pass through the fused tick fold
(``feature_attention.ops.feature_fold``) instead.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.feature_attention.ops import feature_attention
from repro_torch.models.transformer import check_family


def first_layer_path(cfg: ModelConfig) -> Tuple[str, ...]:
    """Path (nested dict keys) of the feature-learning target parameter:
    the paper models' first layer, a transformer's token embedding."""
    if cfg.family == "lstm":
        return ("w_x",)
    if cfg.family == "cnn":
        return ("conv1_w",)
    # transformer families: the token embedding is the first layer after
    # the input
    check_family(cfg)
    return ("embed", "table")


def _get(tree, path: Sequence[str]):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path: Sequence[str], value):
    """A copy of the dicts along ``path`` with ``value`` at its end; every
    other node and leaf is shared."""
    out = dict(tree)
    out[path[0]] = (value if len(path) == 1
                    else _set(tree[path[0]], path[1:], value))
    return out


def apply_feature_learning(params: Dict[str, Any], cfg: ModelConfig,
                           *, use_kernel: Optional[bool] = None
                           ) -> Dict[str, Any]:
    """Params with the Eq. (5)-(6) pass applied to the first layer (a new
    tree; the other leaves are shared, and nothing is written in place).
    With tied embeddings the head is the embedding, so the pass changes
    it too.  ``use_kernel`` follows :func:`feature_attention`: on the card
    one launch of the per-row kernel over the whole layer, e.g. (vocab,
    d) for a transformer."""
    path = first_layer_path(cfg)
    w1 = feature_attention(_get(params, path), use_kernel=use_kernel)
    return _set(params, path, w1)
