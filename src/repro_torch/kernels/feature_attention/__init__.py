from repro_torch.kernels.feature_attention.ops import feature_attention

__all__ = ["feature_attention"]
