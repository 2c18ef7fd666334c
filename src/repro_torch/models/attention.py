"""Attention: GQA (prefill through flash attention, fixed-shape KV-cache
decode) and DeepSeek-style multi-head latent attention (MLA).

Mirrors ``repro.models.attention`` on one card: the JAX code's
``DistContext`` argument is gone (its ``constrain`` is a no-op off a
mesh) and its ``attention_impl`` switch becomes ``gqa_forward``'s
``attention``: ``"flash"`` (serving) is the port's dispatch — a CUDA
tensor runs the hand-written flash-attention kernel (K3), a CPU tensor
its plain version — and ``"blocked"`` (training, JAX's ``"xla"``) runs
``blocked_attention`` on every device, under autograd: K3 has no
backward, and its wrapper refuses inputs that require grad.  One-token
decode attention is plain PyTorch,
as it is plain jnp in the JAX package.  MLA's prefill runs
``blocked_attention``, plain PyTorch on every device, as every JAX
branch does (its q/k head dim differs from its v head dim, and K3 never
sees it); its decode is weight-absorbed, in the latent space.
Cross-attention (``kv_override``: Whisper's decoder over the encoder
states) also runs ``blocked_attention`` on every device, as the JAX code
sends it there under every ``attention_impl``.  M-RoPE (Qwen2-VL)
rotates q and k when the config has sections and ``mrope_pos`` is given.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import mrope, rope
from repro_torch.models.spec import ParamDef

NEG_INF = -1e30
INT_SENTINEL = 2 ** 31 - 1
# gqa_forward's self-attention: "flash" (the flash_attention dispatcher:
# K3 on the card) or "blocked" (blocked_attention, differentiable)
ATTENTIONS = ("flash", "blocked")


def _pick_block(s_kv: int, target: int = 1024) -> int:
    b = min(target, s_kv)
    while s_kv % b and b > 1:
        b //= 2
    if b >= 128 or b == s_kv:
        return max(b, 1)
    # awkward sequence length (no power-of-2 divisor >= 128): prefer one
    # big block over hundreds of tiny steps
    if s_kv <= 4 * target:
        return s_kv
    for cand in range(min(target, s_kv), 127, -1):
        if s_kv % cand == 0:
            return cand
    return s_kv


def _attend_block(acc, m, l, q32, qp, ki, vi, kp, *, causal: bool,
                  window: int, scale: float):
    """One KV block of ``blocked_attention``'s online softmax: the carry
    (acc, m, l) and the block's keys, values and key positions -> the
    new carry."""
    ki, vi = ki.to(torch.float32), vi.to(torch.float32)
    kp = kp.to(torch.int64)[:, None, None, None, :]
    s = torch.einsum("bqkgd,btkd->bqkgt", q32, ki) * scale
    mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=q32.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    pv = torch.einsum("bqkgt,btkd->bqkgd", p, vi)
    return acc * corr[..., None] + pv, m_new, l


def blocked_attention(q, k, v, *, q_positions, k_positions,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      block_size: int = 1024):
    """Online-softmax attention over KV blocks, in fp32: q (B, Sq, KV, G,
    hd), k (B, Skv, KV, hd), v (B, Skv, KV, vd) (the value dim may differ
    from the key dim), positions (B, Sq) / (B, Skv) int -> (B, Sq, KV, G,
    vd) in q's dtype.  The JAX function's block choice and arithmetic,
    block by block, out of place (differentiable: the training loss runs
    it under autograd).

    Under autograd each block's body is checkpointed, as the JAX body is
    ``jax.checkpoint``-ed: the backward recomputes the block's scores
    from the carry and the block's keys, values and positions, so no
    (B, Sq, KV, G, block) tensor outlives its block.  The forward runs
    the same operations either way."""
    B, Sq, KV, G, hd = q.shape
    S_kv = k.shape[1]
    vd = v.shape[-1]
    blk = _pick_block(S_kv, block_size)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    q32 = q.to(torch.float32)
    acc = torch.zeros((B, Sq, KV, G, vd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    qp = q_positions.to(torch.int64)[:, :, None, None, None]
    body = functools.partial(_attend_block, causal=causal, window=window,
                             scale=scale)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for t0 in range(0, S_kv, blk):
        block = (acc, m, l, q32, qp, k[:, t0:t0 + blk], v[:, t0:t0 + blk],
                 k_positions[:, t0:t0 + blk])
        if remat:
            acc, m, l = checkpoint(body, *block, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            acc, m, l = body(*block)
        del block  # the previous carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


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


def project_q(params, x, cfg: ModelConfig):
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
    return q


def _project_qkv(params, x, cfg: ModelConfig):
    q = project_q(params, x, cfg)
    k = torch.einsum("bsd,dke->bske", x, params["wk"])
    v = torch.einsum("bsd,dke->bske", x, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return q, k, v


def _apply_rope(cfg: ModelConfig, q, k, q_pos, k_pos, mrope_pos=None):
    """M-RoPE where the config has sections and ``mrope_pos`` (3, B, S)
    is given, else plain RoPE by ``q_pos`` / ``k_pos``: the JAX rule."""
    if cfg.mrope_sections and mrope_pos is not None:
        return (mrope(q, mrope_pos, cfg.mrope_sections, cfg.rope_theta),
                mrope(k, mrope_pos, cfg.mrope_sections, cfg.rope_theta))
    return rope(q, q_pos, cfg.rope_theta), rope(k, k_pos, cfg.rope_theta)


def gqa_forward(params, x, cfg: ModelConfig, *, positions=None,
                mrope_pos=None, causal: bool = True, window: int = 0,
                use_rope: bool = True, kv_override=None,
                return_kv: bool = False, attention: str = "flash"):
    """x (B, S, d) -> (B, S, d); with ``return_kv`` also the rotated
    (k, v, k_positions) for the cache.  Self-attention runs through
    ``flash_attention`` (K3 on the card) with ``attention="flash"`` and
    through ``blocked_attention`` with ``"blocked"`` (training); with
    ``kv_override = (k, v, k_positions)`` (cross-attention: keys and
    values given, (B, Skv, KV, hd)) only q is projected, and
    ``blocked_attention`` attends either way."""
    if attention not in ATTENTIONS:
        raise ValueError(f"attention={attention!r}: one of {ATTENTIONS}")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    if kv_override is not None:
        q = project_q(params, x, cfg)
        k, v, k_positions = kv_override
        if use_rope and not cfg.mrope_sections:
            q = rope(q, positions, cfg.rope_theta)
        out = blocked_attention(q.reshape(B, S, KV, G, hd), k, v,
                                q_positions=positions,
                                k_positions=k_positions, causal=causal,
                                window=window)
    else:
        q, k, v = _project_qkv(params, x, cfg)
        if use_rope:
            q, k = _apply_rope(cfg, q, k, positions, positions, mrope_pos)
        k_positions = positions
        # head h = kv * G + g reads KV head h // G: the JAX ops' order
        attend = (flash_attention if attention == "flash"
                  else blocked_attention)
        out = attend(q.reshape(B, S, KV, G, hd), k, v,
                     q_positions=positions, k_positions=positions,
                     causal=causal, window=window)
    out = out.reshape(B, S, H, hd)
    y = torch.einsum("bshe,hed->bsd", out, params["wo"])
    if return_kv:
        return y, (k, v, k_positions)
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


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig):
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq": ParamDef((d, H, dn + dr), init="fan_in"),
            "w_dkv": ParamDef((d, r), init="fan_in"),
            "w_kr": ParamDef((d, dr), init="fan_in"),
            "kv_norm": ParamDef((r,), init="ones"),
            "w_uk": ParamDef((r, H, dn), init="fan_in"),
            "w_uv": ParamDef((r, H, dv), init="fan_in"),
            "wo": ParamDef((H, dv, d), init="fan_in")}


def _mla_compress(params, x):
    """x -> (normalized latent c_kv (B, S, r), rotary key k_r (B, S,
    dr)), unrotated."""
    c_kv = x @ params["w_dkv"]
    c32 = c_kv.to(torch.float32)
    c_kv = (c32 * torch.rsqrt(torch.mean(torch.square(c32), -1,
                                         keepdim=True) + 1e-6)
            * params["kv_norm"].to(torch.float32)).to(x.dtype)
    return c_kv, x @ params["w_kr"]


def mla_forward(params, x, cfg: ModelConfig, *, positions=None,
                causal: bool = True, window: int = 0,
                return_kv: bool = False):
    """x (B, S, d) -> (B, S, d); with ``return_kv`` also (c_kv, the
    rotated k_r, positions) for the latent cache.  Full-rank q and k
    (the shared rotary key broadcast to every head) go through
    ``blocked_attention`` with the scale of the q/k head dim."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_r = _mla_compress(params, x)
    k_r = rope(k_r[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uk"])
    vh = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uv"])
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_r[:, :, None, :].expand(B, S, H, dr)], -1)
    out = blocked_attention(qf.reshape(B, S, H, 1, dn + dr), kf, vh,
                            q_positions=positions, k_positions=positions,
                            causal=causal, window=window,
                            scale=1.0 / math.sqrt(dn + dr))
    y = torch.einsum("bshe,hed->bsd", out.reshape(B, S, H, dv),
                     params["wo"])
    if return_kv:
        return y, (c_kv, k_r, positions)
    return y


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None):
    """The decode cache holds the compressed latent and the rotary key:
    the paper's memory win."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_r": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), INT_SENTINEL, dtype=torch.int32,
                          device=device),
    }


def mla_decode(params, x, cache, cur_index, cfg: ModelConfig):
    """Weight-absorbed one-token MLA: x (B, 1, d), cur_index (B,) int.
    The new latent and rotary key go into their slots of ``cache`` in
    place (the JAX code returns a new cache) before the token attends
    over it in the latent space.  Returns (y (B, 1, d), cache)."""
    B = x.shape[0]
    dn = cfg.qk_nope_head_dim
    dr = cfg.qk_rope_head_dim
    pos = cur_index[:, None]
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, pos, cfg.rope_theta)  # (B, 1, H, dr)
    c_new, kr_new = _mla_compress(params, x)
    kr_new = rope(kr_new[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]
    slots = cache["c_kv"].shape[1]
    widx = (cur_index % slots).long()
    bidx = torch.arange(B, device=x.device)
    cache["c_kv"][bidx, widx] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_r"][bidx, widx] = kr_new[:, 0].to(cache["k_r"].dtype)
    cache["pos"][bidx, widx] = cur_index.to(torch.int32)
    c32 = cache["c_kv"].to(torch.float32)
    # absorbed query: q_lat (B, 1, H, r) = q_nope @ w_uk^T, head by head
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, params["w_uk"])
    s = (torch.einsum("bshr,btr->bhst", q_lat.to(torch.float32), c32)
         + torch.einsum("bshe,bte->bhst", q_rope.to(torch.float32),
                        cache["k_r"].to(torch.float32))
         )[:, :, 0] / math.sqrt(dn + dr)  # (B, H, S)
    mask = cache["pos"][:, None, :].to(torch.int64) \
        <= cur_index.to(torch.int64)[:, None, None]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, c32)
    out = torch.einsum("bhr,rhe->bhe", o_lat,
                       params["w_uv"].to(torch.float32))
    y = torch.einsum("bhe,hed->bd", out.to(x.dtype), params["wo"])[:, None]
    return y, cache
