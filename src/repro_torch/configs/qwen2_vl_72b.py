"""Qwen2-VL-72B — vision-language model backbone with M-RoPE.

[arXiv:2409.12191]  80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The ViT vision tower is a STUB per the assignment carve-out: ``input_specs``
feeds precomputed (B, n_patches, d_model) patch embeddings occupying the
first ``n_patches`` sequence positions.  M-RoPE (temporal/height/width
rotary sections 16/24/24 of head_dim=128) is implemented for real.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("qwen2-vl-72b")
def qwen2_vl_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        citation="arXiv:2409.12191",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,  # Qwen2 attention uses QKV bias
        mrope_sections=(16, 24, 24),  # (t, h, w) halves of head_dim/2
        n_patches=1024,  # stub: one 32x32-patch image prefix per sequence
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        act="swiglu",
        parallel_strategy="tp",
    )
