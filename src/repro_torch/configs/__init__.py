"""Architecture configs.  Importing this package registers every arch."""
from repro_torch.configs.base import ARCHS, ModelConfig, get_arch

# Register the paper's architectures (import side effect).
from repro_torch.configs import paper_models  # noqa: F401,E402

__all__ = ["ARCHS", "ModelConfig", "get_arch"]
