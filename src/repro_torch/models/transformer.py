"""Model assembly for every transformer family of the JAX package: the
dense trunk, the VLM (the dense trunk with M-RoPE and a patch-embedding
prefix), the MoE family (GQA or MLA attention), the Mamba-1 SSM, the
RG-LRU hybrid and the audio encoder-decoder (Whisper).

Mirrors ``repro.models.transformer``: the per-layer parameters stay
stacked with a leading layer axis, under ``"blocks"`` (dense, vlm, ssm),
under ``"dense_blocks"`` (the leading dense layers) and ``"moe_blocks"``
(moe), under ``"superblocks"`` (each an (rglru, rglru, attn) triple) and
``"tail"`` (the trailing rglru layers) for the hybrid, or under
``"enc_blocks"``, ``"enc_norm"`` and ``"dec_blocks"`` (audio), the JAX
layout, so ``params_from_numpy`` carries a JAX tree across leaf for
leaf.  The forward walks them with a Python loop over views where the
JAX code scans.

``forward_hidden`` takes the self-attention as ``attention``: ``"flash"``
(K3 on the card; the serve path and ``logits_fn``) or ``"blocked"``
(``blocked_attention``, what ``loss_fn`` trains on, as the JAX package
trains on XLA's).  The Mamba and RG-LRU recurrences have one route,
``kernels/linear_scan/ops.py::linear_scan``, the counterpart of both JAX
scan branches: its plain recurrence on the CPU and K2 on the card, under
grad through an autograd Function whose backward is the reverse
recurrence (K2's backward kernel on the card), so every family trains on
either device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.spec import stack_spec

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
# the weight of the MoE load-balance term in the training loss
AUX_LOSS_WEIGHT = 0.01


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"unknown family {cfg.family!r} of {cfg.name!r}: the transformer "
            f"families are {', '.join(FAMILIES)}")


def _attn_spec(cfg: ModelConfig):
    return attn.mla_spec(cfg) if cfg.use_mla else attn.gqa_spec(cfg)


def dense_block_spec(cfg: ModelConfig):
    return {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
            "attn": _attn_spec(cfg),
            "ln2": L.norm_spec(cfg.norm, cfg.d_model),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act)}


def moe_block_spec(cfg: ModelConfig):
    s = {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
         "attn": _attn_spec(cfg),
         "ln2": L.norm_spec(cfg.norm, cfg.d_model),
         "moe": moe_lib.moe_spec(cfg)}
    if cfg.n_shared_experts:
        s["shared"] = L.mlp_spec(
            cfg.d_model, cfg.n_shared_experts * cfg.d_ff_expert, cfg.act)
    return s


def ssm_block_spec(cfg: ModelConfig):
    return {"ln": L.norm_spec(cfg.norm, cfg.d_model),
            "mamba": ssm_lib.mamba_spec(cfg)}


def _mix_mlp_spec(cfg: ModelConfig, mix_spec):
    return {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
            "mix": mix_spec,
            "ln2": L.norm_spec(cfg.norm, cfg.d_model),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act)}


def hybrid_superblock_spec(cfg: ModelConfig):
    return {"r1": _mix_mlp_spec(cfg, rglru_lib.rglru_spec(cfg)),
            "r2": _mix_mlp_spec(cfg, rglru_lib.rglru_spec(cfg)),
            "a": _mix_mlp_spec(cfg, attn.gqa_spec(cfg))}


def enc_block_spec(cfg: ModelConfig):
    return dense_block_spec(cfg)


def dec_block_spec(cfg: ModelConfig):
    return {"ln1": L.norm_spec(cfg.norm, cfg.d_model),
            "self": attn.gqa_spec(cfg),
            "lnx": L.norm_spec(cfg.norm, cfg.d_model),
            "cross": attn.gqa_spec(cfg),
            "ln2": L.norm_spec(cfg.norm, cfg.d_model),
            "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act)}


def build_spec(cfg: ModelConfig) -> Dict[str, Any]:
    check_family(cfg)
    V, d = cfg.vocab_size, cfg.d_model
    spec: Dict[str, Any] = {"embed": L.embedding_spec(V, d),
                            "final_norm": L.norm_spec(cfg.norm, d)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = L.lm_head_spec(d, V)
    if cfg.family == "hybrid":
        n_super, rem = divmod(cfg.n_layers, 3)
        spec["superblocks"] = stack_spec(hybrid_superblock_spec(cfg),
                                         n_super)
        if rem:
            spec["tail"] = stack_spec(
                _mix_mlp_spec(cfg, rglru_lib.rglru_spec(cfg)), rem)
        return spec
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        if nd:
            spec["dense_blocks"] = stack_spec(dense_block_spec(cfg), nd)
        spec["moe_blocks"] = stack_spec(moe_block_spec(cfg),
                                        cfg.n_layers - nd)
        return spec
    if cfg.family == "audio":
        spec["enc_blocks"] = stack_spec(enc_block_spec(cfg),
                                        cfg.encoder_layers)
        spec["enc_norm"] = L.norm_spec(cfg.norm, d)
        spec["dec_blocks"] = stack_spec(dec_block_spec(cfg), cfg.n_layers)
        return spec
    block = ssm_block_spec if cfg.family == "ssm" else dense_block_spec
    spec["blocks"] = stack_spec(block(cfg), cfg.n_layers)
    return spec


def layer(stacked, i: int):
    """Layer ``i``'s parameters: views into the stacked tree."""
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    return {k: layer(v, i) for k, v in stacked.items()}


def attend(p, h, cfg: ModelConfig, *, positions=None, mrope_pos=None,
           window=0, return_kv: bool = False, attention: str = "flash"):
    """The layer's causal self-attention: MLA (``blocked_attention``
    whatever ``attention`` says) or GQA (``attention`` as in
    ``gqa_forward``), rotated by ``mrope_pos`` where the config has
    M-RoPE sections."""
    if cfg.use_mla:
        return attn.mla_forward(p, h, cfg, positions=positions,
                                window=window, return_kv=return_kv)
    return attn.gqa_forward(p, h, cfg, positions=positions,
                            mrope_pos=mrope_pos, causal=True, window=window,
                            return_kv=return_kv, attention=attention)


def _dense_block(p, x, cfg: ModelConfig, *, positions=None, mrope_pos=None,
                 window=0, attention: str = "flash"):
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    x = x + attend(p["attn"], h, cfg, positions=positions,
                   mrope_pos=mrope_pos, window=window, attention=attention)
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + L.mlp(p["mlp"], h, cfg.act)


def moe_ffn(p, h, cfg: ModelConfig):
    """The MoE layer's feed-forward on the normed input, the routed
    experts plus the shared MLP, and the routing's load-balance term."""
    y, aux = moe_lib.moe_forward(p["moe"], h, cfg)
    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], h, cfg.act)
    return y, aux


def _moe_block(p, x, cfg: ModelConfig, *, positions=None,
               attention: str = "flash"):
    """(x after the layer, its load-balance term)."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    x = x + attend(p["attn"], h, cfg, positions=positions,
                   attention=attention)
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    y, aux = moe_ffn(p, h, cfg)
    return x + y, aux


def moe_layers(tree, cfg: ModelConfig):
    """The MoE family's layers in order, as (kind, view of ``tree``): the
    leading dense layers, then the MoE ones.  ``tree`` is the parameters
    (``dense_blocks``, ``moe_blocks``) or the cache (``dense_kv``,
    ``moe_kv``)."""
    nd = cfg.first_dense_layers
    dense, moe = (("dense_blocks", "moe_blocks") if "moe_blocks" in tree
                  else ("dense_kv", "moe_kv"))
    return ([("dense", layer(tree[dense], i)) for i in range(nd)]
            + [("moe", layer(tree[moe], i))
               for i in range(cfg.n_layers - nd)])


def _hybrid_sub(p, x, cfg: ModelConfig, kind: str,
                attention: str = "flash"):
    """One hybrid layer: the mixer (RG-LRU, or local attention over the
    last ``local_window`` positions) and the MLP, each pre-normed and
    residual."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    if kind == "rglru":
        m = rglru_lib.rglru_forward(p["mix"], h, cfg)
    else:
        m = attn.gqa_forward(p["mix"], h, cfg, causal=True,
                             window=cfg.local_window, attention=attention)
    x = x + m
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + L.mlp(p["mlp"], h, cfg.act)


def hybrid_layers(tree, cfg: ModelConfig):
    """The hybrid's layers in order, as (kind, view of ``tree``):
    superblock i's r1, r2 and a, then the tail's rglru layers.  ``tree``
    is the parameters (stacked under ``superblocks`` and ``tail``) or the
    cache (under ``super`` and ``tail``); a view written in place writes
    the stacked tensor."""
    n_super, rem = divmod(cfg.n_layers, 3)
    sup = tree["superblocks"] if "superblocks" in tree else tree["super"]
    out = []
    for i in range(n_super):
        sb = layer(sup, i)
        out += [("rglru", sb["r1"]), ("rglru", sb["r2"]), ("attn", sb["a"])]
    return out + [("rglru", layer(tree["tail"], j)) for j in range(rem)]


def _embed_inputs(params, cfg: ModelConfig, batch):
    """tokens (+ the vlm's patch stub) -> (x, positions, mrope_pos): the
    vlm's ``n_patches`` patch embeddings, cast to the embedding's dtype,
    take the first token rows, and its (3, B, S) M-RoPE positions lay
    them out on a square grid; other families' ``mrope_pos`` is None."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    mrope_pos = None
    if cfg.family == "vlm":
        P = cfg.n_patches
        if S < P:  # the JAX code fails on the shape mismatch
            raise ValueError(f"a vlm prompt of {S} positions is shorter "
                             f"than its {P}-patch prefix")
        x = torch.cat([batch["patches"].to(x.dtype), x[:, P:]], dim=1)
        mrope_pos = L.mrope_positions(P, int(P ** 0.5), S, B, x.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions, mrope_pos


def _sinusoidal(seq: int, d: int, dtype, device=None) -> torch.Tensor:
    """Whisper's (seq, d) sinusoidal positions: sin on the even columns,
    cos on the odd, in fp32 as the JAX code computes them, then cast."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    step = -torch.log(torch.tensor(10000.0)) / d  # fp32, as jnp.log
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32) * step)
    ang = pos * div.to(device)
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(seq, d).to(dtype)


def _whisper_encode(params, cfg: ModelConfig, frames,
                    attention: str = "flash") -> torch.Tensor:
    """frames (B, F, d), the stub frontend's embeddings in the weights'
    dtype -> encoder states: the sinusoid added in the frames' dtype,
    then per layer non-causal self-attention without RoPE (``attention``
    as in ``gqa_forward``: K3 on the card by default) and the MLP, then
    ``enc_norm``."""
    wdt = params["embed"]["table"].dtype
    if frames.dtype != wdt:  # JAX would promote; the port does not
        raise TypeError(f"frames are {frames.dtype}, the weights {wdt}: "
                        "feed the frames in the weights' dtype")
    B, F, d = frames.shape
    x = frames + _sinusoidal(F, d, frames.dtype, frames.device)
    for i in range(cfg.encoder_layers):
        p = layer(params["enc_blocks"], i)
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        x = x + attn.gqa_forward(p["attn"], h, cfg, causal=False,
                                 use_rope=False, attention=attention)
        h = L.apply_norm(cfg.norm, p["ln2"], x)
        x = x + L.mlp(p["mlp"], h, cfg.act)
    return L.apply_norm(cfg.norm, params["enc_norm"], x)


def whisper_decoder_inputs(params, cfg: ModelConfig, tokens, enc):
    """(x, positions, enc_pos) of Whisper's decoder: the token embeddings
    plus the fp32 sinusoid cast to their dtype, and the arange positions
    of the tokens and of the encoder's frames."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    x = x + _sinusoidal(S, cfg.d_model, torch.float32, x.device).to(x.dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    F = enc.shape[1]
    enc_pos = torch.arange(F, dtype=torch.int32,
                           device=x.device).expand(B, F)
    return x, positions, enc_pos


def whisper_dec_block(p, x, cfg: ModelConfig, positions, enc, enc_pos,
                      attention: str = "flash"):
    """One decoder layer over the tokens: causal self-attention without
    RoPE (``attention`` as in ``gqa_forward``: K3 on the card by
    default), cross-attention over the encoder states
    (``blocked_attention``), the MLP.  Returns (x, the self-attention's
    (k, v, positions), the cross (k, v))."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    a, kv = attn.gqa_forward(p["self"], h, cfg, positions=positions,
                             causal=True, use_rope=False, return_kv=True,
                             attention=attention)
    x = x + a
    h = L.apply_norm(cfg.norm, p["lnx"], x)
    c = p["cross"]
    kx = torch.einsum("bsd,dke->bske", enc, c["wk"])
    vx = torch.einsum("bsd,dke->bske", enc, c["wv"])
    if cfg.qkv_bias:
        kx = kx + c["bk"].to(kx.dtype)
        vx = vx + c["bv"].to(vx.dtype)
    x = x + attn.gqa_forward(c, h, cfg, causal=False, use_rope=False,
                             kv_override=(kx, vx, enc_pos))
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + L.mlp(p["mlp"], h, cfg.act), kv, (kx, vx)


def _whisper_hidden(params, cfg: ModelConfig, batch,
                    attention: str = "flash") -> torch.Tensor:
    enc = _whisper_encode(params, cfg, batch["frames"], attention)
    x, positions, enc_pos = whisper_decoder_inputs(params, cfg,
                                                   batch["tokens"], enc)
    for i in range(cfg.n_layers):
        x = whisper_dec_block(layer(params["dec_blocks"], i), x, cfg,
                              positions, enc, enc_pos, attention)[0]
    return L.apply_norm(cfg.norm, params["final_norm"], x)


def forward_hidden(params, cfg: ModelConfig, batch,
                   attention: str = "flash"):
    """Token (and stub) inputs -> (final hidden states (B, S, d), aux):
    aux is the fp32 sum of the MoE layers' load-balance terms (0 for
    the other families), as the JAX ``forward_hidden`` returns it."""
    if cfg.family == "audio":
        x = _whisper_hidden(params, cfg, batch, attention)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    x, positions, mrope_pos = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        for kind, p in hybrid_layers(params, cfg):
            x = _hybrid_sub(p, x, cfg, kind, attention)
    elif cfg.family == "moe":
        for kind, p in moe_layers(params, cfg):
            if kind == "dense":
                x = _dense_block(p, x, cfg, positions=positions,
                                 attention=attention)
            else:
                x, block_aux = _moe_block(p, x, cfg, positions=positions,
                                          attention=attention)
                aux = aux + block_aux
    else:
        for i in range(cfg.n_layers):
            p = layer(params["blocks"], i)
            if cfg.family == "ssm":
                x = x + ssm_lib.mamba_forward(
                    p["mamba"], L.apply_norm(cfg.norm, p["ln"], x), cfg)
            else:
                x = _dense_block(p, x, cfg, positions=positions,
                                 mrope_pos=mrope_pos,
                                 window=cfg.sliding_window,
                                 attention=attention)
    return L.apply_norm(cfg.norm, params["final_norm"], x), aux


def _head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def loss_fn(params, cfg: ModelConfig, batch, attention: str = "blocked"):
    """(ce + AUX_LOSS_WEIGHT * aux, {"ce", "aux"}): the chunked token
    cross-entropy against ``batch["labels"]`` (masked by
    ``batch["mask"]`` where given) through the head, on hidden states
    formed with ``attention`` (``"blocked"``: differentiable on every
    device)."""
    x, aux = forward_hidden(params, cfg, batch, attention)
    ce = L.chunked_softmax_xent(x, _head_matrix(params, cfg),
                                batch["labels"], mask=batch.get("mask"))
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def logits_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    return forward_hidden(params, cfg, batch)[0] @ _head_matrix(params, cfg)
