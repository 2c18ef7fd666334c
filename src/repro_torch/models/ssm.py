"""Mamba-1 selective-SSM block (Falcon-Mamba architecture).

Mirrors ``repro.models.ssm`` on one card, in the JAX package's order of
every fp32 operation.  The prefill's selective scan takes that package's
default branch, ``scan_impl="xla"``'s ``_fused_chunk_scan``, with and
without grad: ``kernels/linear_scan/ops.py::selective_scan`` gets ``xh``,
``dt`` (after the softplus), ``A = -exp(A_log)`` and the B/C projection
``bc`` and returns ``y = h . C`` and the last state.  On a CUDA tensor
that is the fused selective-scan kernel (one launch a layer), which forms
``exp(dt A)`` and ``dt B x`` in registers, runs the recurrence and writes
``y``, so no ``(B, S, d_inner, N)`` tensor exists; on a CPU tensor its
plain version, JAX's chunk loop in PyTorch.  Under grad the forward also
keeps the state before each chunk of JAX's rule (256 steps, fewer where
S is short or not a multiple: the ``lax.scan`` carries), and the
backward (the fused backward kernel on the card, one launch a layer)
recomputes one chunk's states at a time from them, as JAX's
checkpointed chunk body: no tensor larger than one chunk's states is
held.

Decode is one plain fp32 recurrence step (``linear_scan_step``) and
launches no kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linear_scan.ops import selective_scan
from repro_torch.models.scan_utils import linear_scan_step
from repro_torch.models.spec import ParamDef


def mamba_spec(cfg: ModelConfig):
    d, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_dt_rank, cfg.ssm_conv)
    return {
        "w_in_x": ParamDef((d, di), init="fan_in"),
        "w_in_z": ParamDef((d, di), init="fan_in"),
        "conv_w": ParamDef((K, di), init="fan_in"),
        "conv_b": ParamDef((di,), init="zeros"),
        "w_x_dt": ParamDef((di, R), init="fan_in"),
        "w_x_bc": ParamDef((di, 2 * N), init="fan_in"),
        "w_dt": ParamDef((R, di), init="fan_in"),
        "b_dt": ParamDef((di,), init="uniform_scaled", scale=4.0),
        "A_log": ParamDef((di, N), init="uniform_scaled", scale=1.0),
        "D": ParamDef((di,), init="ones"),
        "w_out": ParamDef((di, d), init="fan_in"),
    }


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 prev=None) -> torch.Tensor:
    """Depthwise causal conv over S via K shifted adds (K is tiny).

    x: (B, S, di); prev: (B, K-1, di) decode context or None (zero-pad).
    Taps j = 0..K-1, then the bias, summed in fp32; cast back to x's dtype.
    """
    K = conv_w.shape[0]
    B, S, di = x.shape
    if prev is None:
        prev = x.new_zeros((B, K - 1, di))
    xp = torch.cat([prev, x], dim=1)  # (B, S+K-1, di)
    w32 = conv_w.to(torch.float32)
    out = torch.zeros((B, S, di), dtype=torch.float32, device=x.device)
    for j in range(K):
        out += xp[:, j:j + S].to(torch.float32) * w32[j]
    out += conv_b.to(torch.float32)
    return out.to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _scan_inputs(params, xh: torch.Tensor):
    """xh: (B, S, di) post-conv activations -> (dt (B, S, di) fp32 after
    the softplus, A = -exp(A_log) (di, N) fp32, bc = [B | C] (B, S, 2N)
    in xh's dtype): what the coefficients are formed from."""
    dt_r = xh @ params["w_x_dt"]  # (B, S, R)
    bc = xh @ params["w_x_bc"]  # (B, S, 2N)
    dt = _softplus((dt_r @ params["w_dt"]).to(torch.float32)
                   + params["b_dt"].to(torch.float32))  # (B, S, di)
    A = -torch.exp(params["A_log"].to(torch.float32))  # (di, N)
    return dt, A, bc


def _ssm_coeffs(params, xh: torch.Tensor):
    """xh: (B, S, di) post-conv activations -> (dA, dBx: (B, S, di, N)
    fp32, C: (B, S, N) in xh's dtype)."""
    N = params["A_log"].shape[1]
    dt, A, bc = _scan_inputs(params, xh)
    Bc, Cc = bc[..., :N], bc[..., N:]
    dA = (dt[..., None] * A).exp_()
    # (dt * B) * x, the JAX order
    dBx = dt[..., None] * Bc[..., None, :].to(torch.float32)
    dBx.mul_(xh[..., None].to(torch.float32))
    return dA, dBx, Cc


def _gate_out(params, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    """y + D * xh, gated by silu(z) in fp32, cast, then the out-projection."""
    y = y + params["D"].to(torch.float32) * xh.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(dtype)
    return y @ params["w_out"]


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """x: (B, S, d) -> (B, S, d); with ``return_state`` also the decode
    state ``{"h": (B, di, N) fp32, "conv": (B, K-1, di) in x's dtype}``."""
    xa = x @ params["w_in_x"]  # (B, S, di)
    z = x @ params["w_in_z"]
    xc = _causal_conv(xa, params["conv_w"], params["conv_b"])
    xh = F.silu(xc.to(torch.float32)).to(x.dtype)
    del xc
    # JAX's default _fused_chunk_scan: the fused kernel on the card
    dt, A, bc = _scan_inputs(params, xh)
    y, h_last = selective_scan(xh, dt, A, bc)
    del dt
    out = _gate_out(params, y, xh, z, x.dtype)
    if return_state:
        K = cfg.ssm_conv
        return out, {"h": h_last.to(torch.float32),
                     "conv": xa[:, -(K - 1):]}
    return out


def mamba_init_state(cfg: ModelConfig, batch: int, dtype, device=None):
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": torch.zeros((batch, di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(params, x: torch.Tensor, state, cfg: ModelConfig):
    """x: (B, 1, d); state carries (h, conv window) -> (out (B, 1, d),
    the new state).  ``state`` is read, not written."""
    xa = x @ params["w_in_x"]  # (B, 1, di)
    z = x @ params["w_in_z"]
    xc = _causal_conv(xa, params["conv_w"], params["conv_b"],
                      prev=state["conv"])
    xh = F.silu(xc.to(torch.float32)).to(x.dtype)  # (B, 1, di)
    dA, dBx, Cc = _ssm_coeffs(params, xh)
    h_new = linear_scan_step(dA[:, 0], dBx[:, 0], state["h"])  # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h_new.to(torch.float32),
                     Cc[:, 0].to(torch.float32))
    out = _gate_out(params, y, xh[:, 0], z[:, 0], x.dtype)[:, None]
    conv_new = torch.cat([state["conv"][:, 1:], xa], dim=1)
    return out, {"h": h_new, "conv": conv_new}
