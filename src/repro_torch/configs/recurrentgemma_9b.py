"""RecurrentGemma-9B — Griffin hybrid: RG-LRU + local attention, 2:1.

[arXiv:2402.19427]  38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000,
block pattern (rglru, rglru, attn), local window 2048, lru_width=4096.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        citation="arXiv:2402.19427",
        n_layers=38,  # 12 full (rglru,rglru,attn) blocks + 2 trailing rglru
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        head_dim=256,
        block_pattern=("rglru", "rglru", "attn"),
        local_window=2048,
        lru_width=4096,
        norm="rmsnorm",
        act="swiglu",  # GeGLU in the paper; gated-MLP shape identical
        parallel_strategy="tp",
    )
