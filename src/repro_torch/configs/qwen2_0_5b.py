"""Qwen2-0.5B — small dense GQA model with QKV bias.

[arXiv:2407.10671]  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("qwen2-0.5b")
def qwen2_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        citation="arXiv:2407.10671",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        act="swiglu",
    )
