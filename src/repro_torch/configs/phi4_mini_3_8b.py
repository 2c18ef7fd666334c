"""Phi-4-mini-3.8B — dense RoPE + SwiGLU + GQA model.

[arXiv:2412.08905]  32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
RoPE over the whole head dim (128), as the JAX package's config has it:
the published partial rotary and LongRoPE scaling are not modelled.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("phi4-mini-3.8b")
def phi4_mini_3_8b() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        citation="arXiv:2412.08905",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        tie_embeddings=True,
        rope_theta=10000.0,
        norm="rmsnorm",
        act="swiglu",
        # the JAX package's mesh layout (24 heads don't divide its 16-way
        # model axis); stored, unused on one card
        parallel_strategy="seqp",
    )
