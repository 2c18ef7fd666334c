"""Core layer library: norms, MLPs, embeddings, RoPE.

Pure functions over explicit parameter dicts in the JAX layouts, with the
``*_spec`` companions that declare them, as ``repro.models.layers``.
Norms and activations compute in fp32 and cast back, as the JAX code
does.  M-RoPE (Qwen2-VL) belongs to a later slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.spec import ParamDef

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int):
    return {"scale": ParamDef((d,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_spec(d: int):
    return {"scale": ParamDef((d,), init="ones"),
            "bias": ParamDef((d,), init="zeros")}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) \
        + params["bias"].to(torch.float32)
    return y.to(x.dtype)


def norm_spec(kind: str, d: int):
    return rmsnorm_spec(d) if kind == "rmsnorm" else layernorm_spec(d)


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
# MLP (SwiGLU gated / GELU)
# ---------------------------------------------------------------------------


def mlp_spec(d: int, f: int, act: str):
    """Gated (swiglu) or plain (gelu) MLP."""
    if act == "swiglu":
        return {"w_gate": ParamDef((d, f), init="fan_in"),
                "w_up": ParamDef((d, f), init="fan_in"),
                "w_down": ParamDef((f, d), init="fan_in")}
    return {"w_up": ParamDef((d, f), init="fan_in"),
            "b_up": ParamDef((f,), init="zeros"),
            "w_down": ParamDef((f, d), init="fan_in"),
            "b_down": ParamDef((d,), init="zeros")}


def mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        return h @ params["w_down"]
    h = x @ params["w_up"] + params["b_up"].to(x.dtype)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return h @ params["w_down"] + params["b_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d: int):
    return {"table": ParamDef((vocab, d), init="normal")}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["table"])


def lm_head_spec(d: int, vocab: int):
    return {"w": ParamDef((d, vocab), init="fan_in")}


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """1 / theta**(i / half), i < half, in fp32 as the JAX code computes
    it, always on the host (where it equals XLA's bit for bit) so every
    device rotates by the same frequencies."""
    half = head_dim // 2
    i = torch.arange(half, dtype=torch.float32)
    return (1.0 / (theta ** (i / half))).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Apply rotary embedding.

    x: (..., S, H, hd); positions: broadcastable to (..., S) int.
    Rotates pairs (x[..., :half], x[..., half:]) -- llama convention.
    """
    freqs = _rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope(*_args, **_kwargs):
    raise NotImplementedError(
        "M-RoPE (Qwen2-VL multimodal rotary positions) is not ported yet: "
        "the port runs the dense family's standard RoPE")
