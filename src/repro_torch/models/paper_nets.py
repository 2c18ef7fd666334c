"""The paper's model architectures (ASO-Fed §5.3, Appendix B), in PyTorch.

* LSTM: single-layer LSTM + one fully-connected head.
* CNN: two conv layers + max-pool + FC.

Parameters keep the JAX package's layouts (``repro.models.paper_nets``):
LSTM ``w_x`` is ``(F, 4H)`` with gates in (i, f, g, o) order, CNN kernels
are HWIO ``(3, 3, C_in, C_out)``.  The server's Eq. (5)-(6) feature pass
takes its softmax over the trailing axis of exactly these layouts, so the
layouts are part of the algorithm, not a convention.

Every forward and loss also takes parameters **stacked over a leading
client axis** (the cohort engine's batched local rounds): a stacked
``w_x`` is ``(P, F, 4H)`` and the inputs then carry the same leading
``P`` axis.  Stacked losses return one value per client.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F_

from repro_torch.configs.base import ModelConfig

Params = Dict[str, torch.Tensor]
# name -> (shape, init) with init "fan_in" (normal / sqrt(fan_in)) | "zeros"
Spec = Dict[str, Tuple[Tuple[int, ...], str]]


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def lstm_spec(cfg: ModelConfig) -> Spec:
    F, H, O = cfg.in_features, cfg.hidden, cfg.out_features
    return {
        # W_x is the paper's "first layer after the input" (feature learning)
        "w_x": ((F, 4 * H), "fan_in"),
        "w_h": ((H, 4 * H), "fan_in"),
        "b": ((4 * H,), "zeros"),
        "fc_w": ((H, O), "fan_in"),
        "fc_b": ((O,), "zeros"),
    }


def _lstm_stacked(p: Params, x: torch.Tensor) -> torch.Tensor:
    """p stacked (P, ...), x (P, B, T, F) -> (P, B, O)."""
    P, B, T, F = x.shape
    H = p["w_h"].shape[1]
    # the input projection has no recurrent dependence: one batched GEMM
    # over all (B*T) rows per client, outside the time loop
    zx = torch.bmm(x.reshape(P, B * T, F), p["w_x"]).reshape(P, B, T, 4 * H)
    zx = zx + p["b"][:, None, None, :]
    h = x.new_zeros(P, B, H)
    c = x.new_zeros(P, B, H)
    # unbind, not zx[:, :, t]: the backward of T indexings would build T
    # zero-filled copies of the whole zx and add them; unbind's is one
    # stack
    for zxt in zx.unbind(2):
        z = zxt + torch.bmm(h, p["w_h"])
        i, f, g, o = z.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return torch.bmm(h, p["fc_w"]) + p["fc_b"][:, None, :]


def lstm_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, F) -> (B, O) prediction from the last hidden state; with
    stacked params, x: (P, B, T, F) -> (P, B, O)."""
    if params["w_h"].dim() == 3:
        return _lstm_stacked(params, x)
    one = {k: v[None] for k, v in params.items()}
    return _lstm_stacked(one, x[None])[0]


# ---------------------------------------------------------------------------
# CNN
# ---------------------------------------------------------------------------


def cnn_spec(cfg: ModelConfig) -> Spec:
    C = cfg.hidden  # conv channels
    O = cfg.out_features
    return {
        # first conv == the server feature-learning layer (flattened rows)
        "conv1_w": ((3, 3, 1, C), "fan_in"),
        "conv1_b": ((C,), "zeros"),
        "conv2_w": ((3, 3, C, C), "fan_in"),
        "conv2_b": ((C,), "zeros"),
        "fc_w": ((14 * 14 * C, O), "fan_in"),
        "fc_b": ((O,), "zeros"),
    }


def _grouped_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """Per-client 3x3 SAME conv + ReLU as one grouped convolution.

    x: (B, P*Cin, H, W) with client p's channels in group p; w: stacked
    HWIO (P, 3, 3, Cin, Cout) -> OIHW (P*Cout, Cin, 3, 3), groups=P.
    """
    P, kh, kw, cin, cout = w.shape
    w_oihw = w.permute(0, 4, 3, 1, 2).reshape(P * cout, cin, kh, kw)
    y = F_.conv2d(x, w_oihw, b.reshape(P * cout), padding=1, groups=P)
    return torch.relu(y)


def _cnn_stacked(p: Params, x: torch.Tensor) -> torch.Tensor:
    """p stacked, x (P, B, 28, 28, 1) NHWC -> (P, B, O) logits."""
    P, B, Hh, Ww, _ = x.shape
    C = p["conv1_w"].shape[-1]
    # NHWC per client -> NCHW with the client axis folded into channels
    h = x.permute(1, 0, 4, 2, 3).reshape(B, P, Hh, Ww)
    h = _grouped_conv(h, p["conv1_w"], p["conv1_b"])
    h = _grouped_conv(h, p["conv2_w"], p["conv2_b"])
    h = F_.max_pool2d(h, 2)  # 28 -> 14
    # flatten each client's (14, 14, C) in HWC order, as the JAX model does
    h = h.reshape(B, P, C, Hh // 2, Ww // 2).permute(1, 0, 3, 4, 2)
    h = h.reshape(P, B, -1)
    return torch.bmm(h, p["fc_w"]) + p["fc_b"][:, None, :]


def cnn_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 28, 28, 1) -> (B, O) logits; with stacked params,
    x: (P, B, 28, 28, 1) -> (P, B, O)."""
    if params["conv1_w"].dim() == 5:
        return _cnn_stacked(params, x)
    one = {k: v[None] for k, v in params.items()}
    return _cnn_stacked(one, x[None])[0]


# ---------------------------------------------------------------------------
# Losses / predictions for the paper's tasks
# ---------------------------------------------------------------------------


def _mean(v: torch.Tensor, stacked: bool) -> torch.Tensor:
    return v.flatten(1).mean(1) if stacked else v.mean()


def regression_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``mean((pred - target)**2)`` with each client's arrays broadcast
    as the JAX package broadcasts them: pred (B, O) against the engine's
    (B,) targets is right-aligned to a (B, B) difference matrix, exactly
    as ``repro.models.paper_nets.regression_loss`` computes it.  Stacked:
    pred (P, B, O), target (P, B) -> (P,)."""
    stacked = pred.dim() == 3
    if stacked and target.dim() < pred.dim():
        # per-client right alignment: singleton axes after the client axis
        target = target.reshape(target.shape[:1]
                                + (1,) * (pred.dim() - target.dim())
                                + target.shape[1:])
    return _mean(torch.square(pred - target), stacked)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """Softmax cross-entropy; logits (B, C) [(P, B, C)], int labels."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _mean(nll, logits.dim() == 3)


def multilabel_loss(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy over (B, C) [(P, B, C)] multi-hot
    targets, in the stable ``max(z,0) − z·y + log(1+e^−|z|)`` form."""
    z = logits
    y = targets.to(z.dtype)
    v = torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return _mean(v, z.dim() == 3)


def multilabel_predict(logits: torch.Tensor, threshold: float = 0.5
                       ) -> torch.Tensor:
    """Bool predictions sigmoid(z) >= threshold, taken in logit space."""
    cut = math.log(threshold) - math.log1p(-threshold)
    return logits >= cut


def first_layer_key(cfg: ModelConfig) -> str:
    """The parameter the server's Eq. (5)-(6) feature pass applies to."""
    return "w_x" if cfg.family == "lstm" else "conv1_w"
