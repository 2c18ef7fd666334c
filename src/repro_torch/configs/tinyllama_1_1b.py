"""TinyLlama-1.1B — llama2-architecture small dense model.

[arXiv:2401.02385]  22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("tinyllama-1.1b")
def tinyllama_1_1b() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        citation="arXiv:2401.02385",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        rope_theta=10000.0,
        norm="rmsnorm",
        act="swiglu",
        parallel_strategy="tp",
    )
