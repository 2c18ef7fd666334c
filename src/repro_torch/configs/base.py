"""Model configuration for the port.

``ModelConfig`` keeps the JAX package's field names
(``repro.configs.base``) for the families the port runs: the paper-scale
LSTM / CNN, the dense transformer trunk, the MoE family (with or
without DeepSeek's multi-head latent attention), the Mamba-1 SSM, the
RG-LRU hybrid, the VLM (M-RoPE and a patch-embedding prefix) and the
audio encoder-decoder.
Architectures register in ``ARCHS`` by name and ``get_arch`` builds a
fresh config; ``reduced()`` derives the same family at CPU-test size,
exactly as the JAX package's does for these fields.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.common.registry import Registry

ARCHS: Registry["ModelConfig"] = Registry("architecture")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | lstm | cnn
    citation: str = ""

    # transformer trunk
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10000.0

    # MoE: routed experts (top_k of n_experts), shared experts (one MLP of
    # width n_shared_experts * d_ff_expert), the leading dense layers.
    # The port runs the dropless combine only, so it has no capacity
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0

    # MLA (DeepSeek-style multi-head latent attention), q projected at
    # full rank as in V2-Lite: the port has no q compression
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (Mamba-1): state size N, d_inner = ssm_expand * d_model, the
    # causal conv's taps, and dt's rank (derived: ceil(d_model / 16))
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0

    # hybrid (RecurrentGemma): repeating block pattern
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    local_window: int = 0  # local-attention window (hybrid archs)
    lru_width: int = 0

    # long-context variant for dense archs (0 = full attention)
    sliding_window: int = 0

    # multimodal stubs: the (t, h, w) rotary sections of head_dim / 2 and
    # the patch-embedding prefix (vlm); the encoder's depth and frame
    # count and the decode horizon (audio)
    mrope_sections: Tuple[int, ...] = ()
    n_patches: int = 0
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 0
    max_decode_len: int = 0  # 0 = unlimited

    # the JAX package's mesh layout ("tp" | "seqp" | ...): stored as given
    # and read by nothing, the port runs on one card.  Every dense config
    # sets it as its JAX config does; the default is JAX's
    parallel_strategy: str = "tp"

    # paper-scale models (LSTM / CNN)
    in_features: int = 0
    out_features: int = 0
    hidden: int = 0  # LSTM hidden width / CNN conv channels

    def __post_init__(self):
        if self.n_heads and not self.head_dim and not self.use_mla:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "ssm" and not self.ssm_dt_rank and self.d_model:
            object.__setattr__(self, "ssm_dt_rank",
                               math.ceil(self.d_model / 16))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        return dataclasses.replace(self, sliding_window=window)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        # hybrids keep one full (rglru, rglru, attn) superblock
        min_layers = 3 if self.block_pattern else 2
        r = dataclasses.replace(
            self,
            n_layers=min(self.n_layers, min_layers) if self.n_layers else 0,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=min(self.d_model, 256) if self.d_model else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            d_ff_expert=min(self.d_ff_expert, 128) if self.d_ff_expert else 0,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else 0,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            kv_lora_rank=min(self.kv_lora_rank, 64) if self.kv_lora_rank
            else 0,
            qk_nope_head_dim=min(self.qk_nope_head_dim, 32),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 16),
            v_head_dim=min(self.v_head_dim, 32),
            lru_width=min(self.lru_width, 256) if self.lru_width else 0,
            local_window=(min(self.local_window, 64)
                          if self.local_window else 0),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            encoder_frames=(min(self.encoder_frames, 16)
                            if self.encoder_frames else 0),
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            hidden=min(self.hidden, 64) if self.hidden else 0,
        )
        # recompute derived head_dim for the reduced trunk
        if r.n_heads and not r.use_mla:
            object.__setattr__(r, "head_dim", r.d_model // r.n_heads)
        if r.family == "ssm":
            object.__setattr__(r, "ssm_dt_rank", math.ceil(r.d_model / 16))
        # the rotary sections re-derived for the reduced head dim: at hd
        # 64, (0, 16, 16), whose temporal section is empty
        if r.mrope_sections:
            t = r.head_dim // 4
            object.__setattr__(r, "mrope_sections",
                               (r.head_dim // 2 - 2 * t, t, t))
        return r


def get_arch(name: str) -> ModelConfig:
    return ARCHS.get(name)()
