"""Kimi K2 — trillion-parameter MoE, 32B activated.

[arXiv:2501.kimi2 (paper-table)]  61L d_model=7168 64H (GQA kv=8)
vocab=163840, MoE: 384 routed experts top-8 + 1 shared, expert d_ff=2048,
first layer dense (d_ff=18432).
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("kimi-k2-1t-a32b")
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        citation="arXiv:2501.kimi2",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=18432,  # dense FFN for the leading dense layer
        first_dense_layers=1,
        vocab_size=163840,
        head_dim=112,  # 7168 / 64
        n_experts=384,
        n_shared_experts=1,
        top_k=8,
        d_ff_expert=2048,
        rope_theta=50_000.0,
        norm="rmsnorm",
        act="swiglu",
        parallel_strategy="tp",
    )
