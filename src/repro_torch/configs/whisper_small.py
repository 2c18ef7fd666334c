"""Whisper-small — audio encoder-decoder transformer backbone.

[arXiv:2212.04356]  12L enc + 12L dec, d_model=768, 12H, d_ff=3072,
vocab=51865.  The mel-spectrogram + conv frontend is a STUB per the
assignment carve-out: ``input_specs`` feeds precomputed (B, 1500, d_model)
frame embeddings.  Decoder decode horizon is 448 tokens by model card;
``long_500k`` is skipped (full-attention decoder — DESIGN.md §4).
"""
from repro_torch.configs.base import ARCHS, ModelConfig


@ARCHS.register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        citation="arXiv:2212.04356",
        n_layers=12,  # decoder layers
        encoder_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        is_encoder_decoder=True,
        # 30 s audio at 50 Hz gives 1500 frames; padded to 1536 so the frame
        # axis tiles the 16-way mesh and 512-wide attention blocks (the stub
        # frontend emits the padding — standard production batching).
        encoder_frames=1536,
        max_decode_len=448,
        norm="layernorm",
        act="gelu",
        qkv_bias=True,
        # 12 heads don't divide the 16-way model axis: sequence-parallel attn.
        parallel_strategy="seqp",
    )
