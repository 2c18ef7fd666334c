"""Serving path of the dense trunk: KV cache, prefill, one-token decode.

Mirrors the dense family of ``repro.models.decode``.  Caches are
fixed-shape: ``min(max_len, window)`` slots per layer with absolute-
position tags (``INT_SENTINEL`` = unwritten, masked by the causal check),
circular for the sliding-window variant, stacked over a leading layer
axis.  Prefill runs every layer's attention through flash attention (K3
on the card, one launch per layer); decode is plain PyTorch.

One difference from the JAX code, which returns a new cache:
``decode_step`` writes the new token's K/V into the cache it is given
and returns that same cache.  On the card a copy of the whole cache per
token would double the step's cache traffic.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_embed_inputs, _head_matrix,
                                            check_family, layer)

INT_SENTINEL = attn.INT_SENTINEL


def _attn_slots(cfg: ModelConfig, max_len: int) -> int:
    W = cfg.sliding_window or 0
    return min(max_len, W) if W else max_len


def _gqa_cache(cfg: ModelConfig, B: int, slots: int, dtype, layers,
               device) -> Dict[str, torch.Tensor]:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    lead = (layers,) if layers is not None else ()
    return {
        "k": torch.zeros(lead + (B, slots, KV, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (B, slots, KV, hd), dtype=dtype,
                         device=device),
        "pos": torch.full(lead + (B, slots), INT_SENTINEL, dtype=torch.int32,
                          device=device),
    }


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    check_family(cfg)
    return {"kv": _gqa_cache(cfg, B, _attn_slots(cfg, max_len), dtype,
                             cfg.n_layers, device)}


def _kv_to_cache(k, v, positions, slots: int):
    """Pack full-sequence K/V (B, S, KV, hd) into a slot cache: padded
    with unwritten slots when S <= slots, else the last ``slots``
    positions at their circular slots (position p in slot p % slots)."""
    B, S = k.shape[:2]
    if S <= slots:
        pad = slots - S
        return {
            "k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)),
            "pos": torch.nn.functional.pad(positions.to(torch.int32),
                                           (0, pad), value=INT_SENTINEL),
        }
    perm = torch.arange(S - slots, S) % slots
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(slots)
    inv = inv.to(k.device)
    return {
        "k": k[:, S - slots:][:, inv],
        "v": v[:, S - slots:][:, inv],
        "pos": positions[:, S - slots:][:, inv].to(torch.int32),
    }


def prefill(params, cfg: ModelConfig, batch, max_len: Optional[int] = None):
    """Returns (last-token logits (B, V), cache).  The cache holds K/V in
    the compute dtype (the parameters')."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    x, positions = _embed_inputs(params, cfg, batch)
    slots = _attn_slots(cfg, max_len)
    kv = _gqa_cache(cfg, B, slots, x.dtype, cfg.n_layers, x.device)
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        a, (k, v, kpos) = attn.gqa_forward(
            p["attn"], hh, cfg, positions=positions, causal=True,
            window=cfg.sliding_window, return_kv=True)
        x = x + a
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], hh, cfg.act)
        for name, t in _kv_to_cache(k, v, kpos, slots).items():
            kv[name][i].copy_(t)
    # the norm is row-wise: normalizing only the last position is exact
    last = L.apply_norm(cfg.norm, params["final_norm"], x[:, -1])
    return last @ _head_matrix(params, cfg), {"kv": kv}


def _commit_kv(kv_cache, k_new, v_new, cur_index):
    """Deferred cache commit for all layers at once, in place.
    k_new / v_new: (L, B, KV, hd)."""
    Lyr, B = k_new.shape[0], k_new.shape[1]
    slots = kv_cache["k"].shape[2]
    widx = (cur_index % slots).long()
    bidx = torch.arange(B, device=k_new.device)
    kv_cache["k"][:, bidx, widx] = k_new.to(kv_cache["k"].dtype)
    kv_cache["v"][:, bidx, widx] = v_new.to(kv_cache["v"].dtype)
    kv_cache["pos"][:, bidx, widx] = cur_index.to(torch.int32)[None].expand(
        Lyr, B)
    return kv_cache


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_index):
    """tokens (B, 1) int, cur_index (B,) int -> (logits (B, V), cache);
    the new token's K/V are written into ``cache`` in place."""
    check_family(cfg)
    x = L.embed(params["embed"], tokens)  # (B, 1, d)
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        a, (kn, vn) = attn.gqa_decode(
            p["attn"], hh, layer(cache["kv"], i), cur_index, cfg,
            window=cfg.sliding_window, defer_write=True)
        x = x + a
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], hh, cfg.act)
        k_new.append(kn)
        v_new.append(vn)
    _commit_kv(cache["kv"], torch.stack(k_new), torch.stack(v_new),
               cur_index)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return x[:, 0] @ _head_matrix(params, cfg), cache
