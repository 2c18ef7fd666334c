"""DeepSeek-V2-Lite 16B — MoE with Multi-head Latent Attention.

[arXiv:2405.04434]  27L d_model=2048 16H d_ff(dense)=10944 vocab=102400,
MoE: 64 routed top-6 + 2 shared, expert d_ff=1408, MLA kv_lora_rank=512.

Full DeepSeek-V2 has 160 routed experts; the -Lite variant in the cited
paper has 64 routed + 2 shared, which this config follows (as the JAX
package's does).
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("deepseek-v2-lite-16b")
def deepseek_v2_lite_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        citation="arXiv:2405.04434",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,  # MLA: latent KV, head count == q heads
        d_ff=10944,  # dense FFN (first layer)
        first_dense_layers=1,
        vocab_size=102400,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
        use_mla=True,
        kv_lora_rank=512,  # V2-Lite projects q directly (no q compression)
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        rope_theta=10000.0,
        parallel_strategy="tp",
    )
