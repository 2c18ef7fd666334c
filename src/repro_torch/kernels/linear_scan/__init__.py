from repro_torch.kernels.linear_scan.ops import fold_prefix, linear_scan

__all__ = ["fold_prefix", "linear_scan"]
