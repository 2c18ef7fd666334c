"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Mirrors ``repro.models.rglru`` on one card, in the JAX package's order
and dtypes of every step.  Recurrence:
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))``, c = 8.  Two
parallel branches d_model -> lru_width: the gate branch through GeLU
(fp32), the recurrent branch through a short causal conv and the RG-LRU;
their product is projected back.

The prefill's recurrence goes through
``kernels/linear_scan/ops.py::linear_scan``: K2's CUDA kernel on a CUDA
tensor (one launch a layer), its plain version on a CPU tensor; under
grad its backward is K2's backward kernel on the card (one launch a
layer) and the plain reverse loop on the CPU.  Both
JAX branches map to it: ``scan_impl="pallas"`` calls the same kernel, and
the default ``chunked_linear_scan`` is XLA's blocked form of the same
recurrence, which has no port.  Decode is one plain fp32 step
(``linear_scan_step``) and launches no kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models.scan_utils import linear_scan_step
from repro_torch.models.spec import ParamDef
from repro_torch.models.ssm import _causal_conv, _softplus

_C = 8.0
_CONV_K = 4


def rglru_spec(cfg: ModelConfig):
    d, w = cfg.d_model, cfg.lru_width
    return {
        "w_x": ParamDef((d, w), init="fan_in"),
        "w_gate": ParamDef((d, w), init="fan_in"),
        "conv_w": ParamDef((_CONV_K, w), init="fan_in"),
        "conv_b": ParamDef((w,), init="zeros"),
        "w_a": ParamDef((w, w), init="fan_in"),
        "w_i": ParamDef((w, w), init="fan_in"),
        "lam": ParamDef((w,), init="uniform_scaled", scale=1.0),
        "w_out": ParamDef((w, d), init="fan_in"),
    }


def _gates(params, xc: torch.Tensor):
    """xc: (B, S, w) conv output -> (a, gated input), both fp32: the
    products in xc's dtype, then the sigmoids in fp32."""
    ra = torch.sigmoid((xc @ params["w_a"]).to(torch.float32))
    ri = torch.sigmoid((xc @ params["w_i"]).to(torch.float32))
    log_a = -_C * _softplus(params["lam"].to(torch.float32)) * ra
    a = torch.exp(log_a)
    gated = ri * xc.to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * gated
    return a, b


def rglru_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """x: (B, S, d) -> (B, S, d); with ``return_state`` also the decode
    state ``{"h": (B, w) fp32, "conv": (B, K-1, w) in x's dtype}``."""
    xr = x @ params["w_x"]  # (B, S, w)
    # jax.nn.gelu's default is the tanh form; the gate stays fp32
    g = F.gelu((x @ params["w_gate"]).to(torch.float32), approximate="tanh")
    xc = _causal_conv(xr, params["conv_w"], params["conv_b"])
    a, b = _gates(params, xc)
    h, h_last = linear_scan(a, b)  # K2 on a CUDA tensor
    del a, b
    y = (h.to(torch.float32) * g).to(x.dtype)
    out = y @ params["w_out"]
    if return_state:
        return out, {"h": h_last.to(torch.float32),
                     "conv": xr[:, -(_CONV_K - 1):]}
    return out


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device=None):
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, w), dtype=dtype,
                            device=device),
    }


def rglru_decode(params, x: torch.Tensor, state, cfg: ModelConfig):
    """x: (B, 1, d); state carries (h, conv window) -> (out (B, 1, d),
    the new state).  ``state`` is read, not written."""
    xr = x @ params["w_x"]  # (B, 1, w)
    g = F.gelu((x @ params["w_gate"]).to(torch.float32), approximate="tanh")
    xc = _causal_conv(xr, params["conv_w"], params["conv_b"],
                      prev=state["conv"])
    a, b = _gates(params, xc)
    h_new = linear_scan_step(a[:, 0], b[:, 0], state["h"])  # (B, w)
    y = (h_new.to(torch.float32)[:, None] * g).to(x.dtype)
    out = y @ params["w_out"]
    conv_new = torch.cat([state["conv"][:, 1:], xr], dim=1)
    return out, {"h": h_new, "conv": conv_new}
