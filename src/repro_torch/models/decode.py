"""Serving path of every transformer family: caches, prefill, one-token
decode.

Mirrors ``repro.models.decode``.  Dense (and vlm) caches are
fixed-shape: ``min(max_len, window)`` slots per layer with
absolute-position tags (``INT_SENTINEL`` = unwritten, masked by the
causal check), circular for the sliding-window variant, stacked over a
leading layer axis.  Prefill runs every layer's attention through flash
attention (K3 on the card, one launch per layer).  The SSM cache is the
recurrent state, ``{"state": {"h": (L, B, d_inner, N) fp32, "conv": (L,
B, K-1, d_inner)}}`` in the compute dtype, whatever ``max_len``; its
prefill runs every layer's selective scan through K2 (one launch per
layer on the card).  The hybrid's cache is ``{"super": {"r1", "r2",
"a"}, "tail"}``: the RG-LRU layers' state (``h`` (B, lru_width) fp32,
the conv window in the compute dtype) and each attention layer's ring of
``min(max_len, local_window)`` K/V slots, stacked over the superblocks
and the tail; its prefill launches K2 once an RG-LRU layer and K3 once
an attention layer.  The MoE family's cache is ``{"dense_kv",
"moe_kv"}``, stacked over its leading dense layers and its MoE layers:
K/V slots as the dense family's for GQA (its prefill launches K3 once a
layer), or for MLA the compressed latent ``c_kv`` (B, slots,
kv_lora_rank) and the rotary key ``k_r`` (B, slots, qk_rope_head_dim)
(its prefill runs ``blocked_attention``, no kernel).  The audio
family's cache is ``{"self", "cross_k", "cross_v"}``: the decoder's
self-attention K/V in ``max_len`` slots, and each decoder layer's K/V of
the encoder states, ``(L, B, F, KV, hd)``, written once by the prefill;
its prefill launches K3 once an encoder layer (non-causal) and once a
decoder layer (causal), and runs the cross-attention through
``blocked_attention``.  The vlm's prefill and decode are the dense
family's with M-RoPE positions.  Decode is plain PyTorch in every
family.

One difference from the JAX code, which returns a new cache:
``decode_step`` writes the new token's K/V (dense, hybrid) or the new
recurrent state (ssm, hybrid) into the cache it is given and returns
that same cache (the audio family writes each layer's self-attention
slot before attending, as JAX does, and leaves the cross K/V as they
are).  On the card a copy of the whole cache per token would
double the step's cache traffic.  The new K/V are committed after the
layer loop (``_commit_kv``), as the dense and GQA-MoE families do in
JAX; MLA writes each layer's latent slot before attending, as JAX does;
the hybrid's JAX decode writes each layer's slot before attending instead.
The two agree whenever the ring holds a whole window (``max_len >=
local_window``) or has not wrapped: the slot the new token takes then
holds a position a full window back, which the window masks.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.transformer import (_embed_inputs, _head_matrix,
                                            _sinusoidal, _whisper_encode,
                                            attend, check_family,
                                            hybrid_layers, layer, moe_ffn,
                                            moe_layers, whisper_dec_block,
                                            whisper_decoder_inputs)

INT_SENTINEL = attn.INT_SENTINEL


def _attn_slots(cfg: ModelConfig, max_len: int) -> int:
    W = cfg.sliding_window or 0
    return min(max_len, W) if W else max_len


def _local_slots(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.local_window) if cfg.local_window else max_len


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


def _mla_cache(cfg: ModelConfig, B: int, slots: int, dtype, layers,
               device) -> Dict[str, torch.Tensor]:
    c = attn.mla_init_cache(cfg, B, slots, dtype, device)
    return {k: t.expand((layers,) + t.shape).clone() for k, t in c.items()}


def _ssm_state(cfg: ModelConfig, B: int, dtype, layers: int, device):
    """The layer-stacked recurrent state: ``h`` in fp32, the conv window
    in ``dtype`` (the JAX layout)."""
    st = ssm_lib.mamba_init_state(cfg, B, dtype, device)
    return {k: t.expand((layers,) + t.shape).clone() for k, t in st.items()}


def _lru_state(cfg: ModelConfig, B: int, dtype, layers: int, device):
    """The RG-LRU layers' stacked state: ``h`` in fp32, the conv window
    in ``dtype`` (the JAX layout)."""
    st = rglru_lib.rglru_init_state(cfg, B, dtype, device)
    return {k: t.expand((layers,) + t.shape).clone() for k, t in st.items()}


def _audio_cache(cfg: ModelConfig, B: int, max_len: int, frames: int,
                 dtype, device):
    """The decoder's self-attention K/V in ``max_len`` slots and each
    decoder layer's cross K/V over ``frames`` encoder states."""
    cross = (cfg.n_layers, B, frames, cfg.n_kv_heads, cfg.head_dim)
    return {"self": _gqa_cache(cfg, B, max_len, dtype, cfg.n_layers, device),
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    check_family(cfg)
    if cfg.family == "audio":
        return _audio_cache(cfg, B, max_len, cfg.encoder_frames, dtype,
                            device)
    if cfg.family == "ssm":
        return {"state": _ssm_state(cfg, B, dtype, cfg.n_layers, device)}
    if cfg.family == "hybrid":
        n_super, rem = divmod(cfg.n_layers, 3)
        c = {"super": {
            "r1": _lru_state(cfg, B, dtype, n_super, device),
            "r2": _lru_state(cfg, B, dtype, n_super, device),
            "a": _gqa_cache(cfg, B, _local_slots(cfg, max_len), dtype,
                            n_super, device)}}
        if rem:
            c["tail"] = _lru_state(cfg, B, dtype, rem, device)
        return c
    if cfg.family == "moe":
        mk = _mla_cache if cfg.use_mla else _gqa_cache
        slots = _attn_slots(cfg, max_len)
        nd = cfg.first_dense_layers
        c = {"moe_kv": mk(cfg, B, slots, dtype, cfg.n_layers - nd, device)}
        if nd:
            c["dense_kv"] = mk(cfg, B, slots, dtype, nd, device)
        return c
    return {"kv": _gqa_cache(cfg, B, _attn_slots(cfg, max_len), dtype,
                             cfg.n_layers, device)}


def _to_slots(leaves: Dict[str, torch.Tensor], positions, slots: int):
    """Pack full-sequence cache leaves (B, S, ...) into a slot cache with
    their positions: padded with unwritten slots when S <= slots, else
    the last ``slots`` positions at their circular slots (position p in
    slot p % slots)."""
    B, S = positions.shape
    if S <= slots:
        pad = slots - S
        out = {n: torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                          + (0, pad))
               for n, t in leaves.items()}
        out["pos"] = torch.nn.functional.pad(positions.to(torch.int32),
                                             (0, pad), value=INT_SENTINEL)
        return out
    perm = torch.arange(S - slots, S) % slots
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(slots)
    inv = inv.to(positions.device)
    out = {n: t[:, S - slots:][:, inv] for n, t in leaves.items()}
    out["pos"] = positions[:, S - slots:][:, inv].to(torch.int32)
    return out


def _kv_to_cache(k, v, positions, slots: int):
    """K/V (B, S, KV, hd) into ``slots`` slots."""
    return _to_slots({"k": k, "v": v}, positions, slots)


def _latent_to_cache(c_kv, k_r, positions, slots: int):
    """MLA's latent (B, S, r) and rotary key (B, S, dr) into ``slots``
    slots."""
    return _to_slots({"c_kv": c_kv, "k_r": k_r}, positions, slots)


def _ssm_prefill(params, cfg: ModelConfig, x):
    """The ssm layers over the prompt's embeddings: (final hidden x, the
    cache with the layer-stacked recurrent state)."""
    state = _ssm_state(cfg, x.shape[0], x.dtype, cfg.n_layers, x.device)
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        hh = L.apply_norm(cfg.norm, p["ln"], x)
        out, st = ssm_lib.mamba_forward(p["mamba"], hh, cfg,
                                        return_state=True)
        x = x + out
        for name, t in st.items():
            state[name][i].copy_(t)
    return x, {"state": state}


def _dense_prefill(params, cfg: ModelConfig, x, positions, slots: int,
                   mrope_pos=None):
    """The dense (vlm) layers over the prompt's embeddings: (final hidden
    x, the cache with ``slots`` K/V slots a layer)."""
    kv = _gqa_cache(cfg, x.shape[0], slots, x.dtype, cfg.n_layers, x.device)
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        a, (k, v, kpos) = attn.gqa_forward(
            p["attn"], hh, cfg, positions=positions, mrope_pos=mrope_pos,
            causal=True, window=cfg.sliding_window, return_kv=True)
        x = x + a
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], hh, cfg.act)
        for name, t in _kv_to_cache(k, v, kpos, slots).items():
            kv[name][i].copy_(t)
    return x, {"kv": kv}


def _hybrid_prefill(params, cfg: ModelConfig, x, positions, slots: int):
    """The hybrid's layers over the prompt's embeddings: (final hidden x,
    the cache: each RG-LRU layer's state, each attention layer's last
    ``slots`` K/V at their ring slots)."""
    cache = init_cache(cfg, x.shape[0], slots, x.dtype, x.device)
    for (kind, p), (_, c) in zip(hybrid_layers(params, cfg),
                                 hybrid_layers(cache, cfg)):
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        if kind == "rglru":
            m, entry = rglru_lib.rglru_forward(p["mix"], hh, cfg,
                                               return_state=True)
        else:
            m, (k, v, kpos) = attn.gqa_forward(
                p["mix"], hh, cfg, positions=positions, causal=True,
                window=cfg.local_window, return_kv=True)
            entry = _kv_to_cache(k, v, kpos, slots)
        x = x + m
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], hh, cfg.act)
        for name, t in entry.items():
            c[name].copy_(t)
    return x, cache


def _moe_prefill(params, cfg: ModelConfig, x, positions, slots: int):
    """The MoE family's layers over the prompt's embeddings: (final hidden
    x, the cache: each layer's K/V (GQA) or latent (MLA) in ``slots``
    slots)."""
    cache = init_cache(cfg, x.shape[0], slots, x.dtype, x.device)
    for (kind, p), (_, c) in zip(moe_layers(params, cfg),
                                 moe_layers(cache, cfg)):
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        a, kv = attend(p["attn"], hh, cfg, positions=positions,
                       return_kv=True)
        entry = (_latent_to_cache if cfg.use_mla else _kv_to_cache)(
            *kv, slots)
        x = x + a
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + (L.mlp(p["mlp"], hh, cfg.act) if kind == "dense"
                 else moe_ffn(p, hh, cfg)[0])
        for name, t in entry.items():
            c[name].copy_(t)
    return x, cache


def _audio_prefill(params, cfg: ModelConfig, batch, max_len: int):
    """Whisper: the encoder over ``batch["frames"]``, then the decoder
    layers over the tokens: (final hidden x, the cache with the self K/V
    in ``max_len`` slots and every layer's cross K/V)."""
    enc = _whisper_encode(params, cfg, batch["frames"])
    x, positions, enc_pos = whisper_decoder_inputs(params, cfg,
                                                   batch["tokens"], enc)
    cache = _audio_cache(cfg, x.shape[0], max_len, enc.shape[1], x.dtype,
                         x.device)
    for i in range(cfg.n_layers):
        x, kv, (kx, vx) = whisper_dec_block(
            layer(params["dec_blocks"], i), x, cfg, positions, enc, enc_pos)
        for name, t in _kv_to_cache(*kv, max_len).items():
            cache["self"][name][i].copy_(t)
        cache["cross_k"][i].copy_(kx)
        cache["cross_v"][i].copy_(vx)
    return x, cache


def prefill(params, cfg: ModelConfig, batch, max_len: Optional[int] = None):
    """Returns (last-token logits (B, V), cache).  The cache holds K/V
    (dense, vlm, hybrid, GQA MoE, audio), the latent (MLA) or the conv
    window (ssm, hybrid) in the compute dtype (the parameters'); the ssm
    cache ignores ``max_len``.  ``batch`` holds the tokens (B, S) and the
    family's stub embeddings: ``frames`` (audio; in the weights' dtype)
    or ``patches`` (vlm)."""
    S = batch["tokens"].shape[1]
    if cfg.family == "audio":
        x, cache = _audio_prefill(params, cfg, batch, max_len or S)
        last = L.apply_norm(cfg.norm, params["final_norm"], x[:, -1])
        return last @ _head_matrix(params, cfg), cache
    x, positions, mrope_pos = _embed_inputs(params, cfg, batch)
    if cfg.family == "ssm":
        x, cache = _ssm_prefill(params, cfg, x)
    elif cfg.family == "hybrid":
        x, cache = _hybrid_prefill(params, cfg, x, positions,
                                   _local_slots(cfg, max_len or S))
    elif cfg.family == "moe":
        x, cache = _moe_prefill(params, cfg, x, positions,
                                _attn_slots(cfg, max_len or S))
    else:
        x, cache = _dense_prefill(params, cfg, x, positions,
                                  _attn_slots(cfg, max_len or S), mrope_pos)
    # the norm is row-wise: normalizing only the last position is exact
    last = L.apply_norm(cfg.norm, params["final_norm"], x[:, -1])
    return last @ _head_matrix(params, cfg), cache


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


def _ssm_decode(params, cfg: ModelConfig, state, x):
    """One token through the ssm layers; each layer's new state is
    written into ``state`` in place."""
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        hh = L.apply_norm(cfg.norm, p["ln"], x)
        out, new = ssm_lib.mamba_decode(p["mamba"], hh, layer(state, i), cfg)
        x = x + out
        for name, t in new.items():
            state[name][i].copy_(t)
    return x


def _dense_decode(params, cfg: ModelConfig, kv, x, cur_index,
                  mrope_pos=None):
    """One token through the dense (vlm) layers; the new K/V of every
    layer are committed into ``kv`` in place at the end."""
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        a, (kn, vn) = attn.gqa_decode(
            p["attn"], hh, layer(kv, i), cur_index, cfg,
            window=cfg.sliding_window, mrope_pos=mrope_pos, defer_write=True)
        x = x + a
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], hh, cfg.act)
        k_new.append(kn)
        v_new.append(vn)
    _commit_kv(kv, torch.stack(k_new), torch.stack(v_new), cur_index)
    return x


def _hybrid_decode(params, cfg: ModelConfig, cache, x, cur_index):
    """One token through the hybrid's layers; each RG-LRU layer's new
    state is written into ``cache`` in place, and the attention layers'
    new K/V are committed into their rings at the end."""
    k_new, v_new = [], []
    for (kind, p), (_, c) in zip(hybrid_layers(params, cfg),
                                 hybrid_layers(cache, cfg)):
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        if kind == "rglru":
            m, new = rglru_lib.rglru_decode(p["mix"], hh, c, cfg)
            for name, t in new.items():
                c[name].copy_(t)
        else:
            m, (kn, vn) = attn.gqa_decode(
                p["mix"], hh, c, cur_index, cfg, window=cfg.local_window,
                defer_write=True)
            k_new.append(kn)
            v_new.append(vn)
        x = x + m
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], hh, cfg.act)
    if k_new:
        _commit_kv(cache["super"]["a"], torch.stack(k_new),
                   torch.stack(v_new), cur_index)
    return x


def _moe_decode(params, cfg: ModelConfig, cache, x, cur_index):
    """One token through the MoE family's layers.  MLA writes each
    layer's latent slot in place before attending; GQA's new K/V are
    committed into ``dense_kv`` and ``moe_kv`` at the end."""
    new = {"dense": ([], []), "moe": ([], [])}
    for (kind, p), (_, c) in zip(moe_layers(params, cfg),
                                 moe_layers(cache, cfg)):
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        if cfg.use_mla:
            a, _ = attn.mla_decode(p["attn"], hh, c, cur_index, cfg)
        else:
            a, (kn, vn) = attn.gqa_decode(p["attn"], hh, c, cur_index, cfg,
                                          defer_write=True)
            new[kind][0].append(kn)
            new[kind][1].append(vn)
        x = x + a
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + (L.mlp(p["mlp"], hh, cfg.act) if kind == "dense"
                 else moe_ffn(p, hh, cfg)[0])
    for kind, (ks, vs) in new.items():
        if ks:
            _commit_kv(cache[f"{kind}_kv"], torch.stack(ks), torch.stack(vs),
                       cur_index)
    return x


def _audio_decode(params, cfg: ModelConfig, cache, x, cur_index):
    """One token through Whisper's decoder layers: each layer's new self
    K/V go into its slot of ``cache["self"]`` in place before it attends
    (write then attend, as JAX does), then the token attends over every
    encoder frame (a query position past every frame's) through
    ``decode_attention``; the cross K/V are only read."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F = cache["cross_k"].shape[2]
    enc_pos = torch.arange(F, dtype=torch.int32, device=x.device).expand(B, F)
    far = torch.full((B,), INT_SENTINEL - 1, dtype=torch.int32,
                     device=x.device)
    for i in range(cfg.n_layers):
        p, sc = layer(params["dec_blocks"], i), layer(cache["self"], i)
        hh = L.apply_norm(cfg.norm, p["ln1"], x)
        a, new = attn.gqa_decode(p["self"], hh, sc, cur_index, cfg,
                                 use_rope=False)
        for name, t in new.items():
            sc[name].copy_(t)
        x = x + a
        hh = L.apply_norm(cfg.norm, p["lnx"], x)
        q = attn.project_q(p["cross"], hh, cfg)
        out = attn.decode_attention(
            q.reshape(B, 1, KV, H // KV, hd), cache["cross_k"][i],
            cache["cross_v"][i], enc_pos, far).reshape(B, 1, H, hd)
        x = x + torch.einsum("bshe,hed->bsd", out, p["cross"]["wo"])
        hh = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], hh, cfg.act)
    return x


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_index):
    """tokens (B, 1) int, cur_index (B,) int -> (logits (B, V), cache);
    the new token's K/V (dense, vlm, hybrid, moe, audio), latent (MLA) or
    the new recurrent state (ssm, which ignores ``cur_index``, and
    hybrid) are written into ``cache`` in place.  The vlm rotates the
    token by M-RoPE at t = h = w = cur_index - n_patches + 1; audio adds
    the sinusoid's row at ``cur_index``, clamped to the self cache's
    slots as JAX's ``mode="clip"`` does."""
    check_family(cfg)
    x = L.embed(params["embed"], tokens)  # (B, 1, d)
    if cfg.family == "audio":
        slots = cache["self"]["k"].shape[2]
        pe = _sinusoidal(slots, cfg.d_model, torch.float32, x.device)
        row = pe[cur_index.long().clamp(0, slots - 1)]
        x = _audio_decode(params, cfg, cache, x + row[:, None].to(x.dtype),
                          cur_index)
    elif cfg.family == "ssm":
        x = _ssm_decode(params, cfg, cache["state"], x)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, cache, x, cur_index)
    elif cfg.family == "moe":
        x = _moe_decode(params, cfg, cache, x, cur_index)
    else:
        mrope_pos = None
        if cfg.family == "vlm":
            t = (cur_index - cfg.n_patches + 1).to(torch.int32)
            mrope_pos = t[None, :, None].expand(3, x.shape[0], 1)
        x = _dense_decode(params, cfg, cache["kv"], x, cur_index, mrope_pos)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return x[:, 0] @ _head_matrix(params, cfg), cache
