"""GQA attention for the dense trunk: prefill through flash attention,
and fixed-shape KV-cache decode.

Mirrors ``repro.models.attention`` on one card: the JAX code's
``DistContext`` argument is gone (its ``constrain`` is a no-op off a
mesh) and its ``attention_impl`` switch becomes the port's dispatch — a
CUDA tensor runs the hand-written flash-attention kernel (K3), a CPU
tensor its plain version.  One-token decode attention is plain PyTorch,
as it is plain jnp in the JAX package.  Cross-attention
(``kv_override``), M-RoPE positions and MLA belong to later slices and
raise by name.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import rope
from repro_torch.models.spec import ParamDef

NEG_INF = -1e30
INT_SENTINEL = 2 ** 31 - 1


def decode_attention(q, k_cache, v_cache, k_positions, q_position, *,
                     window: int = 0, scale: Optional[float] = None,
                     extra_kv=None):
    """One-token cached attention: q (B, 1, KV, G, hd), caches (B, S, KV,
    hd), k_positions (B, S) int (INT_SENTINEL for unwritten slots),
    q_position (B,) -> (B, 1, KV, G, hd).

    With ``extra_kv = (k, v)`` ((B, 1, KV, hd) each: the current token,
    whose cache write is deferred) the token enters as an extra column
    combined in log-space, identical to attending over the updated
    cache."""
    B, _, KV, G, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    q32 = q.to(torch.float32)
    s = torch.einsum("bokgd,btkd->bkgt", q32,
                     k_cache.to(torch.float32)) * scale
    qp = q_position.to(torch.int64)[:, None, None, None]
    kp = k_positions.to(torch.int64)[:, None, None, :]
    mask = kp <= qp
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    if extra_kv is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
        return out[:, None].to(q.dtype)
    ke, ve = extra_kv
    se = torch.einsum("bokgd,bokd->bkgo", q32,
                      ke.to(torch.float32)) * scale
    se = se[..., 0]  # (B, KV, G)
    m = torch.maximum(torch.amax(s, dim=-1), se)
    p_c = torch.exp(s - m[..., None])  # (B, KV, G, S)
    p_e = torch.exp(se - m)  # (B, KV, G)
    num = torch.einsum("bkgt,btkd->bkgd", p_c, v_cache.to(torch.float32))
    num = num + p_e[..., None] * ve[:, 0, :, None, :].to(torch.float32)
    den = torch.sum(p_c, dim=-1) + p_e
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def gqa_spec(cfg: ModelConfig):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {"wq": ParamDef((d, H, hd), init="fan_in"),
         "wk": ParamDef((d, KV, hd), init="fan_in"),
         "wv": ParamDef((d, KV, hd), init="fan_in"),
         "wo": ParamDef((H, hd, d), init="fan_in")}
    if cfg.qkv_bias:
        s["bq"] = ParamDef((H, hd), init="zeros")
        s["bk"] = ParamDef((KV, hd), init="zeros")
        s["bv"] = ParamDef((KV, hd), init="zeros")
    return s


def _project_qkv(params, x, cfg: ModelConfig):
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    k = torch.einsum("bsd,dke->bske", x, params["wk"])
    v = torch.einsum("bsd,dke->bske", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return q, k, v


def _apply_rope(cfg: ModelConfig, q, k, q_pos, k_pos, mrope_pos=None):
    if mrope_pos is not None:
        raise NotImplementedError(
            "M-RoPE positions (mrope_pos) are not ported yet")
    return rope(q, q_pos, cfg.rope_theta), rope(k, k_pos, cfg.rope_theta)


def gqa_forward(params, x, cfg: ModelConfig, *, positions=None,
                mrope_pos=None, causal: bool = True, window: int = 0,
                use_rope: bool = True, kv_override=None,
                return_kv: bool = False):
    """x (B, S, d) -> (B, S, d); with ``return_kv`` also the rotated
    (k, v, k_positions) for the cache.  Attention runs through
    ``flash_attention`` (K3 on the card)."""
    if kv_override is not None:
        raise NotImplementedError(
            "cross-attention (kv_override) is not ported yet")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, cfg)
    if use_rope:
        q, k = _apply_rope(cfg, q, k, positions, positions, mrope_pos)
    # head h = kv * G + g reads KV head h // G: the JAX ops' order
    out = flash_attention(q.reshape(B, S, KV, G, hd), k, v,
                          q_positions=positions, k_positions=positions,
                          causal=causal, window=window)
    out = out.reshape(B, S, H, hd)
    y = torch.einsum("bshe,hed->bsd", out, params["wo"])
    if return_kv:
        return y, (k, v, positions)
    return y


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None):
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    W = cfg.sliding_window
    slots = min(max_len, W) if W else max_len
    return {
        "k": torch.zeros((batch, slots, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, KV, hd), dtype=dtype, device=device),
        # absolute position of each slot; sentinel => masked by causal check
        "pos": torch.full((batch, slots), INT_SENTINEL, dtype=torch.int32,
                          device=device),
    }


def gqa_decode(params, x, cache, cur_index, cfg: ModelConfig, *,
               window: int = 0, mrope_pos=None, use_rope: bool = True,
               defer_write: bool = False):
    """One-token cached attention: x (B, 1, d), cur_index (B,) int.

    ``defer_write=True``: the cache is only read; the new token attends
    through an extra column and its (k, v) ((B, KV, hd) each) are
    returned for one stacked commit after the layer loop.  Otherwise the
    new K/V go into their slots of a new cache, which is returned (the
    input cache is left as it was, as in the JAX code)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    q, k, v = _project_qkv(params, x, cfg)
    pos = cur_index[:, None]  # (B, 1)
    if use_rope:
        q, k = _apply_rope(cfg, q, k, pos, pos, mrope_pos)
    slots = cache["k"].shape[1]
    write_idx = (cur_index % slots).long()
    bidx = torch.arange(B, device=x.device)
    if defer_write:
        k_cache, v_cache, pos_cache = cache["k"], cache["v"], cache["pos"]
        extra = (k, v)
    else:
        k_cache = cache["k"].index_put((bidx, write_idx), k[:, 0])
        v_cache = cache["v"].index_put((bidx, write_idx), v[:, 0])
        pos_cache = cache["pos"].index_put(
            (bidx, write_idx), cur_index.to(torch.int32))
        extra = None
    out = decode_attention(q.reshape(B, 1, KV, G, hd), k_cache, v_cache,
                           pos_cache, cur_index, window=window,
                           extra_kv=extra)
    y = torch.einsum("bshe,hed->bsd", out.reshape(B, 1, H, hd),
                     params["wo"])
    if defer_write:
        return y, (k[:, 0], v[:, 0])
    return y, {"k": k_cache, "v": v_cache, "pos": pos_cache}
