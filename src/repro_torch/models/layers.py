"""Core layer library: norms, MLPs, embeddings, RoPE and M-RoPE, and the
chunked cross-entropy the training loss takes.

Pure functions over explicit parameter dicts in the JAX layouts, with the
``*_spec`` companions that declare them, as ``repro.models.layers``.
Norms, activations and rotations compute in fp32 and cast back, as the
JAX code does.
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


def chunked_softmax_xent(x: torch.Tensor, head_w: torch.Tensor,
                         labels: torch.Tensor, n_chunks: int = 8,
                         mask=None) -> torch.Tensor:
    """Mean token cross-entropy of x (B, S, d) through ``head_w`` (d, V)
    against ``labels`` (B, S) int, over ``n_chunks`` sequence chunks (one
    when S does not divide): each chunk's logits are formed in fp32 and
    reduced to ``logsumexp`` minus the label's logit before the next
    chunk's, and the masked sum is divided by the mask's count (at least
    1), as ``repro.models.layers.chunked_softmax_xent`` (its mesh-only
    ``constrain`` is not ported)."""
    B, S, D = x.shape
    if S % n_chunks:
        n_chunks = 1
    xc = x.reshape(B, n_chunks, S // n_chunks, D).transpose(0, 1)
    lc = labels.reshape(B, n_chunks, S // n_chunks).transpose(0, 1).long()
    mc = (torch.ones(lc.shape, dtype=torch.float32, device=x.device)
          if mask is None else
          mask.reshape(B, n_chunks, S // n_chunks).transpose(0, 1)
          .to(torch.float32))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for xi, li, mi in zip(xc, lc, mc):
        logits = (xi @ head_w).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, li[..., None])[..., 0]
        tot = tot + torch.sum((lse - ll) * mi)
        cnt = cnt + torch.sum(mi)
    return tot / torch.clamp(cnt, min=1.0)


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


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[..., :half], x[..., half:]) of x (..., S, H,
    hd) by the fp32 angles (..., S, half) -- llama convention."""
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Apply rotary embedding.

    x: (..., S, H, hd); positions: broadcastable to (..., S) int.
    """
    freqs = _rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def mrope(x: torch.Tensor, positions_thw: torch.Tensor, sections,
          theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (..., S, H, hd); positions_thw: (3, ..., S) int -- the temporal,
    height and width position streams.  ``sections`` splits the hd / 2
    frequency channels into (t, h, w) groups in that order (a group may
    be empty); each channel rotates by its own group's stream.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = _rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    ends = [sum(sections[:i + 1]) for i in range(3)]
    ang = torch.cat([positions_thw[i][..., None].to(torch.float32)
                     * freqs[end - n:end]
                     for i, (n, end) in enumerate(zip(sections, ends))],
                    dim=-1)  # (..., S, half)
    return _rotate(x, ang)


def mrope_positions(n_patches: int, grid_hw: int, seq_len: int, batch: int,
                    device=None) -> torch.Tensor:
    """Qwen2-VL's static position layout: one image prefix of
    ``n_patches`` (grid_hw x grid_hw; t = 0, h = row, w = column), then
    text (t = h = w = idx - n_patches + 1).  Returns (3, B, S) int32."""
    idx = torch.arange(seq_len, device=device)
    is_img = idx < n_patches
    t = torch.where(is_img, 0, idx - n_patches + 1)
    h = torch.where(is_img, idx // grid_hw, t)
    w = torch.where(is_img, idx % grid_hw, t)
    pos = torch.stack([t, h, w]).to(torch.int32)  # (3, S)
    return pos[:, None, :].expand(3, batch, seq_len)
