"""InternLM2-20B — dense GQA model.

[arXiv:2403.17297]  48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("internlm2-20b")
def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        citation="arXiv:2403.17297",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        act="swiglu",
        parallel_strategy="tp",
    )
