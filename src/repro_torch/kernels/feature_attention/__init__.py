from repro_torch.kernels.feature_attention.ops import (feature_attention,
                                                      feature_fold)

__all__ = ["feature_attention", "feature_fold"]
