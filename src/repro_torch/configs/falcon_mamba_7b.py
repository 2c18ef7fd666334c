"""Falcon-Mamba-7B — attention-free Mamba-1 SSM.

[arXiv:2410.05355]  64L d_model=4096 (attn-free) vocab=65024, ssm_state=16,
expand=2 (d_inner=8192), conv kernel 4, dt_rank=ceil(4096/16)=256.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        citation="arXiv:2410.05355",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        norm="rmsnorm",
        tie_embeddings=True,
        # the JAX package's mesh layout (d_inner over its model axis);
        # stored, unused on one card
        parallel_strategy="tp",
    )
